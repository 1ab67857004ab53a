"""Whether a PlonkWithoutPoseidon proof in the Sha256MerkleChannel flavour
is the proof of its trace: the reference verifier (verifier/stark_sha.py),
under the configuration's own PcsConfig and the trace's public inputs,
accepts its bytes, and the columns it commits to are the trace's own at
the out-of-domain point.

The second part ties the proof to its witness: the reference builds the
table's 8 preprocessed columns and 12 value-limb columns from the trace it
was given, interpolates them and evaluates them at the OODS point its own
transcript draws; a proof of another trace, or a stale one, samples other
values there.
"""

from __future__ import annotations

import numpy as np

from .check_proof import domain_order, eval_at
from .core import qm31_host as q
from .proof.parse_np import parse_plonk_without_poseidon_proof
from .prover.circle_fft_host import interpolate
from .verifier import spec_np, stark_sha

# the table's columns in commitment order (plonk_without_poseidon.rs:633-713)
PREPROCESSED_COLUMNS = ("a_wire", "b_wire", "c_wire", "op1", "op2", "op3", "op4", "mult_c")
VALUE_COLUMNS = tuple(f"{t}_val_{k}" for t in ("a", "b", "c") for k in range(4))


def check(proof_bytes: bytes, config: dict, trace: dict, inputs) -> dict:
    """{'failed_checks': named checks the proof fails (all of them where it
    cannot be parsed, claims another PcsConfig or has another shape),
    'trace_samples_off': trace columns whose OODS sample is not the
    trace's}.  `inputs` is the statement's public inputs, (index, QM31)
    pairs."""
    spec = spec_np.for_config(config)
    names = [n for n in stark_sha.check_names(spec) if n != "ok"]
    n_tied = len(PREPROCESSED_COLUMNS) + len(VALUE_COLUMNS)
    try:
        proof = parse_plonk_without_poseidon_proof(proof_bytes)
        stated = (config["pow_bits"], config["log_last_layer_degree_bound"], config["log_blowup_factor"],
                  config["n_queries"])
        fri = proof.config.fri_config
        if (proof.config.pow_bits, fri.log_last_layer_degree_bound, fri.log_blowup_factor, fri.n_queries) != stated:
            raise ValueError(f"the proof claims {proof.config}, the configuration states another")
        checks, fs = stark_sha.verify_proof(spec, proof, inputs)
    except (AssertionError, ValueError, IndexError, KeyError) as exc:
        return {"failed_checks": len(names), "trace_samples_off": n_tied, "error": repr(exc)}
    failed = sum(not checks[n] for n in names)

    px, py = (q.QM31(*(np.array([c], np.uint32) for c in v)) for v in fs.oods)
    got = []
    for tree, columns in enumerate((PREPROCESSED_COLUMNS, VALUE_COLUMNS)):
        cols = np.stack([np.asarray(trace[name], np.uint32) for name in columns])
        want = eval_at(interpolate(domain_order(cols)), px, py)
        sampled = np.stack([np.asarray(proof.stark_proof.sampled_values[tree][c][0], np.uint32)
                            for c in range(len(columns))])
        got.append((want != sampled).any(axis=1))
    return {"failed_checks": failed, "trace_samples_off": int(np.concatenate(got).sum())}
