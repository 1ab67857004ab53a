"""Top-level batched verifier for PlonkWithPoseidon circle-STARK proofs.

Twin of recursive_stwo_tpu/verifier/verify.py.  verify_batch(spec, pa,
inputs) runs transcript, PoW, total-sum, composition, quotients, FRI folding
and every Merkle decommitment over int64 tensors on pa's device, and returns
a dict of named (B,) bool checks plus their conjunction 'ok', with the
reference's keys in the reference's order.  `structural_checks` (the fold
and hash phases) serves verify_np.py and verify_sha256.py too.

Each phase is a span (utils/spans.py): `verify.transcript`,
`verify.composition`, `verify.fold` (in it the fold kernel's `fold.prepare`
and `verify.walk_jobs`) and `verify.hash` (in it hashplan.py's
`hash.absorb_lower`, `hash.leaf`, `hash.walk_lower` and `hash.scan`).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import composition as composition_mod
from . import fri as fri_mod
from . import hashplan, points, quotients, transcript
from ..utils.spans import span
from .arrays import ProofArrays
from .spec import VerifierSpec
from .transcript import _q_cols

# the public inputs of the two fixtures (recursive_stwo_tpu/verifier/verify.py:27-28)
INPUTS_ONE = ((1, (1, 0, 0, 0)),)
INPUTS_RECURSIVE = ((1, (1, 0, 0, 0)), (2, (0, 1, 0, 0)), (3, (0, 0, 1, 0)))


def verify_batch(
    spec: VerifierSpec,
    pa: ProofArrays,
    inputs: Sequence[Tuple[int, Tuple[int, int, int, int]]] = INPUTS_ONE,
):
    # the transcript, the OODS point and the PoW and logup total-sum checks
    # (sum_i 1/(val_i + idx_i * alpha - z) + sums == 0)
    with span("verify.transcript"):
        fs, oods, _, pow_ok, total_sum_ok = transcript.replay(spec, pa, inputs)
    checks = {"pow": pow_ok, "total_sum": total_sum_ok}

    # composition polynomial at the OODS point
    with span("verify.composition"):
        plonk_sum = _q_cols(pa.plonk_total_sum)
        poseidon_sum = _q_cols(pa.poseidon_total_sum)
        checks["composition"] = composition_mod.composition_check(
            spec, pa.samples_flat, plonk_sum, poseidon_sum,
            (fs.z, fs.alpha), fs.random_coeff, oods,
        )

    checks.update(structural_checks(spec, pa, fs, oods))
    return with_ok(checks)


def with_ok(checks: dict) -> dict:
    """checks plus 'ok', the conjunction of every check, as the last key."""
    ok = None
    for v in checks.values():
        ok = v if ok is None else (ok & v)
    checks["ok"] = ok
    return checks


def structural_checks(spec, pa, fs, oods) -> dict:
    """Quotients, FRI folding and every Merkle check, shared by the with-
    and without-Poseidon verifiers (both read the spec duck-typed)."""
    checks, pair_jobs = fold_phase(spec, pa, fs, oods)
    checks.update(hash_phase(spec, pa, fs, pair_jobs))
    return checks


def fold_phase(spec, pa, fs, oods):
    """Quotient ('FRI answers') evaluation + the FRI fold arithmetic.

    Returns (checks, pair_jobs): the fold-consistency checks and the
    assembled per-layer pair-walk jobs the hash phase consumes.  A CPU
    batch takes the plain version (`fold_values_plain`), a CUDA one the fold
    kernel (ops/fold_cuda.py: one launch for the whole batch)."""
    with span("verify.fold"):
        if fs.raw_queries.device.type == "cpu":
            answers, self_vals, last_ok = fold_values_plain(spec, pa, fs, oods)
        else:
            from ..ops import fold_cuda

            answers, self_vals, last_ok = fold_cuda.fold(
                spec, pa, fs.raw_queries.contiguous(), oods, fs.after_sampled_values_random_coeff, fs.fri_alphas
            )
        with span("verify.walk_jobs"):
            jobs = fri_mod.walk_jobs(spec, fs.raw_queries, pa, answers, self_vals)
    return {"fri_last_layer": last_ok}, jobs


def fold_values_plain(spec, pa, fs, oods):
    """The plain version of the fold kernel: (G, B, Q, 4) answers,
    (n_inner, B, Q, 4) self values and the (B,) last-layer check, in eager
    torch (the half-index chain, each group's quotients, verify_fri)."""
    half_pts = points.half_index_points(spec, fs.raw_queries, spec.final_fold_log)
    answers = []
    for g, L in enumerate(spec.all_log_sizes):
        qL = transcript.queries_at_log_size(spec, fs.raw_queries, L)
        dx, dyq, _ = points.domain_point(half_pts[L], qL)
        rows = torch.cat(
            [pa.tree_paths[t].columns[L] for t in range(4) if L in pa.tree_paths[t].columns],
            dim=-1,
        )
        answers.append(
            quotients.fri_answers_for_group(
                spec, g, oods, fs.after_sampled_values_random_coeff,
                pa.samples_flat, rows, dx, dyq,
            )
        )
    self_vals, last_ok = fri_mod.verify_fri(spec, fs, pa, answers, half_pts)
    return torch.stack([torch.stack(list(a), dim=-1) for a in answers]), self_vals, last_ok


def hash_phase(spec, pa, fs, pair_jobs):
    """All Merkle hashing: one packed absorb pass + one leaf batch + one
    packed walk pass (hashplan.py); yields the tree0-3 and FRI-layer root
    checks."""
    with span("verify.hash"):
        chains = []
        chain_idx = {}

        def add_chain(key, arr):
            chain_idx[key] = len(chains)
            chains.append(arr)

        # dict insertion order fixes the chain order, as in the reference
        for t in range(4):
            for L, cols in pa.tree_paths[t].columns.items():
                add_chain(("tree", t, L), cols)
        for j, job in enumerate(pair_jobs):
            for L in job["self_columns"]:
                add_chain(("self", j, L), job["self_columns"][L])
                add_chain(("sib", j, L), job["sibling_columns"][L])

        digests = hashplan.absorb_packed(chains)

        def dig(key):
            return digests[chain_idx[key]]

        leaf_keys = [("tree", t, spec.tree_max_domain_log[t]) for t in range(4)]
        for j, job in enumerate(pair_jobs):
            leaf_keys.append(("self", j, job["depth"]))
            leaf_keys.append(("sib", j, job["depth"]))
        leaf = dict(zip(leaf_keys, hashplan.leaf_rate_many([dig(k) for k in leaf_keys])))

        single = []
        for t in range(4):
            depth = spec.tree_max_domain_log[t]
            single.append(
                hashplan.SingleWalk(
                    depth=depth,
                    queries=transcript.queries_at_log_size(spec, fs.raw_queries, depth),
                    sibling_hashes=pa.tree_paths[t].sibling_hashes,
                    col_caps={
                        L: dig(("tree", t, L)) for L in pa.tree_paths[t].columns if L != depth
                    },
                    leaf=leaf[("tree", t, depth)],
                    root=pa.commitments[:, t],
                )
            )
        pairs = []
        for j, job in enumerate(pair_jobs):
            d = job["depth"]
            pairs.append(
                hashplan.PairWalk(
                    depth=d,
                    queries=job["queries"],
                    sibling_hashes=job["sibling_hashes"],
                    self_caps={L: dig(("self", j, L)) for L in job["self_columns"] if L != d},
                    sib_caps={L: dig(("sib", j, L)) for L in job["sibling_columns"] if L != d},
                    self_leaf=leaf[("self", j, d)],
                    sib_leaf=leaf[("sib", j, d)],
                    root=job["root"],
                )
            )
        oks, poks = hashplan.walk_scan(single, pairs)
        checks = {f"tree{t}": oks[t] for t in range(4)}
        for j, job in enumerate(pair_jobs):
            checks[f"fri_{job['kind']}"] = poks[j]
        return checks
