"""End-to-end recursive-verifier circuit builder.

`build_verifier_circuit` runs all four in-circuit stages (fiat_shamir ->
composition -> answer -> folding) over one parsed proof, exactly like the
reference `examples/single-proof/src/main.rs:23-95`, returning the
finalized constraint system whose trace tensors feed the prover.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..cs.system import PlonkWithPoseidonCS
from ..gadgets.fields import QM31Var
from ..proof.containers import PlonkWithPoseidonProof
from ..verifier import hints as hints_mod
from ..verifier import transcript_host as transcript
from ..verifier.spec import VerifierSpec
from .answer import AnswerResults
from .composition import CompositionCheck
from .data_structures import ProofVar
from .fiat_shamir import FiatShamirResults
from .folding import FoldingResults


STAGES = ("fiat_shamir", "composition", "answer", "folding")


def build_verifier_circuit(
    proof: PlonkWithPoseidonProof,
    inputs: List[Tuple[int, tuple]],
    cs: PlonkWithPoseidonCS | None = None,
    finalize: bool = True,
    cross_check: bool = True,
    through_stage: str = "folding",
):
    """Verify `proof` inside a PlonkWithPoseidon circuit.

    inputs: [(wire_index, qm31_tuple)] public-input claims.
    Returns (cs, stage results dict). Multiple proofs can share one cs by
    passing it back in (the multi-proofs pattern,
    examples/multi-proofs/src/main.rs:69-139).

    through_stage: build only the stage prefix ending here — mirrors the
    reference's per-stage round-trip tests (e.g.
    components/recursive/fiat_shamir/src/lib.rs:217-234), which prove each
    stage's circuit standalone.
    """
    assert through_stage in STAGES
    k = STAGES.index(through_stage)
    spec = VerifierSpec.from_proof(proof)
    pa = hints_mod.prepare(spec, [proof])
    fs = transcript.run_transcript(spec, pa)
    native_answers = (
        hints_mod.host_fri_answers(spec, fs, pa, pa.tree_paths)
        if cross_check and k >= 2
        else None
    )

    cs = cs or PlonkWithPoseidonCS()
    proof_var = ProofVar(cs, proof)
    input_vars = [
        (idx, QM31Var.new_constant(cs, tuple(v))) for idx, v in inputs
    ]

    fs_results = FiatShamirResults.compute(spec, fs, proof_var, input_vars)
    answer_results = None
    if k >= 1:
        CompositionCheck.compute(
            spec,
            fs_results.lookup_elements,
            fs_results.random_coeff,
            fs_results.oods_point,
            proof_var,
        )
    if k >= 2:
        answer_results = AnswerResults.compute(
            spec,
            fs_results.oods_point,
            fs_results,
            proof_var,
            pa.tree_paths,
            native_answers,
        )
    if k >= 3:
        FoldingResults.compute(
            spec,
            proof_var,
            fs_results,
            answer_results,
            pa.first_layer_paths,
            pa.inner_layer_paths,
        )

    if finalize:
        cs.pad()
        cs.check_arithmetics()
        cs.populate_logup_arguments()
        cs.check_poseidon_invocations()

    return cs, {
        "spec": spec,
        "proof_var": proof_var,
        "fs_results": fs_results,
        "answer_results": answer_results,
    }


def build_last_circuit(
    proof: PlonkWithPoseidonProof,
    inner_inputs: List[Tuple[int, tuple]],
    finalize: bool = True,
    cross_check: bool = True,
    transcript_fn=None,
    hash_node_fn=None,
):
    """Verify `proof` inside a PlonkWithoutPoseidon circuit with all
    Fiat-Shamir/decommitment data as packed public inputs (the last-layer
    flow, examples/last-layer/src/main.rs:30-95).

    transcript_fn/hash_node_fn select the input proof's channel flavor:
    default Poseidon31; pass (verify_sha256.run_transcript_sha256p31 as a
    (spec, pa)->FSOutput closure, sha256_merkle.hash_node) when `proof` is
    a Sha256Poseidon31-flavor proof — the reference's actual input kind
    (components/last/fiat_shamir/src/lib.rs:36-79).

    Returns (cs, results).  The public-input vector follows the reference
    assembly order (main.rs:113-186): 1, i, j are pinned; then t,
    sampled-hash (2), sums (2), z, alpha, random coeffs (2), packed
    queries, fri_alphas, packed decommit columns, pair-proof columns.
    """
    from ..cs.system import PlonkWithoutPoseidonCS
    from . import last as last_mod

    spec = VerifierSpec.from_proof(proof)
    if transcript_fn is None:
        transcript_fn = lambda s, pa_: transcript.run_transcript(s, pa_)  # noqa: E731
    pa = hints_mod.prepare(
        spec, [proof], transcript_fn=transcript_fn, hash_node_fn=hash_node_fn
    )
    fs = transcript_fn(spec, pa)
    native_answers = (
        hints_mod.host_fri_answers(spec, fs, pa, pa.tree_paths)
        if cross_check
        else None
    )

    cs = PlonkWithoutPoseidonCS()

    fs_input = last_mod.LastFiatShamirInput(spec, proof, fs)
    fs_input_var = last_mod.LastFiatShamirInputVar(cs, fs_input)

    tree_columns = [
        {lvl: np.asarray(v)[0] for lvl, v in pa.tree_paths[t].columns.items()}
        for t in range(4)
    ]
    decommit_input_var = last_mod.LastDecommitInputVar(
        cs, tree_columns, spec.n_queries
    )
    first_layer_vars = last_mod.alloc_pair_inputs(
        cs, pa.first_layer_paths, spec.n_queries
    )
    inner_layer_vars = [
        last_mod.alloc_pair_inputs(cs, pp, spec.n_queries)
        for pp in pa.inner_layer_paths
    ]

    proof_var = last_mod.LastProofVar(cs, proof)
    fs_results = last_mod.LastFiatShamirResults.compute(
        proof_var, fs_input_var, inner_inputs
    )
    last_mod.LastCompositionCheck.compute(
        spec,
        fs_results.lookup_elements,
        fs_results.random_coeff,
        fs_results.oods_point,
        proof_var,
    )
    answer_results = last_mod.LastAnswerResults.compute(
        spec,
        fs_results,
        decommit_input_var,
        tree_columns,
        proof_var,
        native_answers,
    )
    last_mod.LastFoldingResults.compute(
        spec,
        proof_var,
        fs_results,
        answer_results,
        first_layer_vars,
        inner_layer_vars,
    )

    if finalize:
        cs.pad()
        cs.check_arithmetics()
        cs.populate_logup_arguments()

    return cs, {
        "spec": spec,
        "proof_var": proof_var,
        "fs_results": fs_results,
        "answer_results": answer_results,
        "fs_input": fs_input,
    }
