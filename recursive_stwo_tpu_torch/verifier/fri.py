"""FRI verification: the fold arithmetic plus assembly of the pair-walk
hash jobs.

Twin of recursive_stwo_tpu/verifier/fri.py: first-layer circle folds,
inner-layer line folds (the reference's `lax.scan` over layers is a Python
loop here) and the last-layer polynomial check (`verify_fri`, the plain
version of that part of the fold kernel, csrc/fold.cu), and one pair-walk
job per FRI layer for the hash phase (`walk_jobs`, which reads the plain
version's or the kernel's answers and self values).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..core import m31
from ..core import qm31 as q
from ..core.qm31 import QM31
from . import points as points_mod
from . import transcript
from .spec import VerifierSpec


def _q_of(arr: torch.Tensor) -> QM31:
    return QM31(arr[..., 0], arr[..., 1], arr[..., 2], arr[..., 3])


def _q_arr(x: QM31) -> torch.Tensor:
    return torch.stack(list(x), dim=-1)


def _bc(x: QM31) -> QM31:
    return QM31(*(c[:, None] for c in x))


def _fold(bit0, v: QM31, sib: QM31, x_inv, alpha: QM31) -> QM31:
    """(l + r) + alpha * (l - r) * x_inv, with (l, r) = (v, sib) swapped iff bit0."""
    c = bit0 != 0
    l = q.q_select(c, sib, v)
    r = q.q_select(c, v, sib)
    f1 = q.q_mul_m31(q.q_sub(l, r), x_inv)
    return q.q_add(q.q_add(l, r), q.q_mul(f1, _bc(alpha)))


def verify_fri(
    spec: VerifierSpec,
    fs,
    pa,
    answers: List[QM31],
    half_pts: Dict[int, tuple],
):
    """The fold arithmetic from each group's answers: returns the
    (n_inner, B, Q, 4) self values (each inner layer's committed leaf
    value) and the (B,) last-layer check."""
    M = spec.max_first_layer_log
    raw = fs.raw_queries
    Q = raw.shape[1]
    n_inner = spec.n_inner_layers

    # One batched inversion: first-layer fold y's and inner-layer fold x's.
    y_folds = []
    for L in spec.all_log_sizes:
        qL = transcript.queries_at_log_size(spec, raw, L)
        y_folds.append(points_mod.domain_point(half_pts[L], qL)[2])
    x_folds = [half_pts[M - 1 - i][0] for i in range(n_inner)]
    inv_all = m31.inv(torch.stack(y_folds + x_folds))
    y_inv = {L: inv_all[g] for g, L in enumerate(spec.all_log_sizes)}
    x_inv = inv_all[len(y_folds):]  # (n_inner, B, Q)

    # ---- first layer circle folds ----
    folded_results: Dict[int, QM31] = {}
    for g, L in enumerate(spec.all_log_sizes):
        qL = transcript.queries_at_log_size(spec, raw, L)
        sib_v = _q_of(pa.first_layer_paths.sibling_columns[L])
        folded_results[L] = _fold(qL & 1, answers[g], sib_v, y_inv[L], fs.fri_alphas[M - L])

    # ---- inner layers ----
    folded = q.q_zero(raw)
    self_vals = []
    for i in range(n_inner):
        L_in = M - i  # log size at loop start
        L = M - 1 - i  # layer log size
        if L_in in folded_results:
            ai = fs.fri_alphas[i]
            folded = q.q_add(q.q_mul(folded, _bc(q.q_mul(ai, ai))), folded_results[L_in])
        self_vals.append(folded)  # leaf value committed at this layer
        qL = transcript.queries_at_log_size(spec, raw, L)
        sib_v = _q_of(pa.inner_layer_paths[i].sibling_columns[L])
        folded = _fold(qL & 1, folded, sib_v, x_inv[i], fs.fri_alphas[i + 1])

    # ---- last layer ----
    ax, ay = half_pts[M - n_inner]
    x = m31.sub(m31.mul(ax, ax), m31.mul(ay, ay))
    if spec.log_last_layer_degree_bound == 0:
        c = pa.last_poly[:, 0]
        expect = QM31(*(c[:, i : i + 1].expand(-1, Q) for i in range(4)))
    else:
        doublings = [x]
        for _ in range(spec.log_last_layer_degree_bound - 1):
            sq = m31.mul(doublings[-1], doublings[-1])
            doublings.append(m31.sub(m31.add(sq, sq), 1))
        v = QM31(*(pa.last_poly[:, None, :, i] for i in range(4)))
        for factor in reversed(doublings):
            lhs = QM31(*(comp[..., 0::2] for comp in v))
            rhs = QM31(*(comp[..., 1::2] for comp in v))
            v = q.q_add(lhs, q.q_mul_m31(rhs, factor[..., None]))
        expect = QM31(*(comp[..., 0] for comp in v))

    eq = torch.ones_like(folded.a, dtype=torch.bool)
    for fx, ex in zip(folded, expect):
        eq = eq & (fx == ex)
    stacked = torch.stack([_q_arr(v) for v in self_vals]) if self_vals else raw.new_empty((0,) + raw.shape + (4,))
    return stacked, eq.all(dim=1)


def walk_jobs(spec: VerifierSpec, raw: torch.Tensor, pa, answers: torch.Tensor, self_vals: torch.Tensor) -> list:
    """One pair-walk hash job per FRI layer: the first layer's (every
    group's (B, Q, 4) answers beside its siblings) and each inner layer's
    (its self values); `answers` is (G, B, Q, 4), `self_vals`
    (n_inner, B, Q, 4)."""
    M = spec.max_first_layer_log
    walk_jobs = [
        dict(
            kind="first",
            depth=M,
            queries=transcript.queries_at_log_size(spec, raw, M),
            sibling_hashes=pa.first_layer_paths.sibling_hashes,
            self_columns={L: answers[g] for g, L in enumerate(spec.all_log_sizes)},
            sibling_columns=dict(pa.first_layer_paths.sibling_columns),
            root=pa.first_layer_commitment,
        )
    ]
    for i in range(spec.n_inner_layers):
        L = M - 1 - i
        walk_jobs.append(
            dict(
                kind=f"inner{i}",
                depth=L,
                queries=transcript.queries_at_log_size(spec, raw, L),
                sibling_hashes=pa.inner_layer_paths[i].sibling_hashes,
                self_columns={L: self_vals[i]},
                sibling_columns={L: pa.inner_layer_paths[i].sibling_columns[L]},
                root=pa.inner_commitments[:, i],
            )
        )
    return walk_jobs
