"""OODS quotient ("FRI answer") evaluation, batched over proofs x queries.

Twin of the verifier half of recursive_stwo_tpu/verifier/quotients.py:
columns are stacked on a trailing axis, the random-coefficient powers come
from one doubling chain, and the per-query numerator is one modular sum over
the column axis.  The sample-batch grouping is the reference's own
`group_batches`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core import m31
from ..core import qm31 as q
from ..core.qm31 import CM31, QM31
from . import points as points_mod
from .quotients_host import group_batches
from .spec import VerifierSpec


def m31_modsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Modular sum along a dimension (exact: the int64 sum of fewer than
    2**32 residues cannot overflow)."""
    return x.sum(dim=dim) % m31.P


def q_modsum(x: QM31, dim: int) -> QM31:
    return QM31(*(m31_modsum(comp, dim) for comp in x))


def rc_power_chain(rc: QM31, n: int) -> QM31:
    """Stacked rc**k for k = 0..n-1; components shaped (n,) + rc.shape.

    Doubling blocks: pows[m:2m] = pows[:m] * rc**m, O(log n) products."""
    pows = QM31(*(c[None] for c in q.q_one(rc.a)))
    block_mult = rc
    while pows.a.shape[0] < n:
        m = min(pows.a.shape[0], n - pows.a.shape[0])
        block = q.q_mul(QM31(*(c[:m] for c in pows)), block_mult)
        pows = QM31(*(torch.cat([c, b]) for c, b in zip(pows, block)))
        block_mult = q.q_mul(block_mult, block_mult)
    return pows


def fri_answers_for_group(
    spec: VerifierSpec,
    g: int,
    oods: Tuple[QM31, QM31],
    random_coeff: QM31,
    samples_flat: torch.Tensor,
    queried_rows: torch.Tensor,
    dom_x: torch.Tensor,
    dom_y: torch.Tensor,
) -> QM31:
    """Quotient values for group g; queried_rows (B, Q, C) in group column
    order; dom_x/dom_y (B, Q).  Returns QM31 of (B, Q)."""
    dev = dom_x.device
    batches = group_batches(spec, g)
    rc_powers = rc_power_chain(random_coeff, sum(len(cols) for _, cols in batches))

    acc = q.q_zero(dom_x)
    k = 0
    for (shift, tlog), cols in batches:
        px, py = (
            oods if shift == 0 else points_mod.shifted_oods_point(oods, shift, tlog)
        )
        C = len(cols)
        local_idx = torch.tensor([c for c, _ in cols], device=dev)
        sample_idx = torch.tensor([s for _, s in cols], device=dev)

        # sampled values, stacked (B, C)
        sv = samples_flat[:, sample_idx]  # (B, C, 4)
        v0 = CM31(sv[..., 0], sv[..., 1])
        v1 = CM31(sv[..., 2], sv[..., 3])
        y0 = CM31(py.a[:, None], py.b[:, None])
        y1 = CM31(py.c[:, None], py.d[:, None])

        # alpha_k = -2u * rc^k for this batch's k-range, (B, C)
        apow = QM31(*(comp[k : k + C].movedim(0, -1) for comp in rc_powers))
        alpha = q.q_mul(apow, QM31(0, 0, m31.P - 2, 0))
        k += C

        a_c = v1
        c_c = y1
        b_c = q.c_sub(q.c_mul(v0, y1), q.c_mul(v1, y0))
        A = q.q_mul_cm31(alpha, a_c)  # (B, C)
        Bq = q.q_mul_cm31(alpha, b_c)
        Cq = q.q_mul_cm31(alpha, c_c)

        # terms over (B, Q, C): Cq*val - (A*dom_y + Bq)
        val = queried_rows[:, :, local_idx]
        Ae = QM31(*(comp[:, None, :] for comp in A))
        Be = QM31(*(comp[:, None, :] for comp in Bq))
        Ce = QM31(*(comp[:, None, :] for comp in Cq))
        term = q.q_sub(
            q.q_mul_m31(Ce, val), q.q_add(q.q_mul_m31(Ae, dom_y[:, :, None]), Be)
        )
        numerator = q_modsum(term, 2)  # (B, Q)

        # denominator inverse (CM31 over (B, Q))
        prx, pix = CM31(px.a[:, None], px.b[:, None]), CM31(px.c[:, None], px.d[:, None])
        pry, piy = CM31(py.a[:, None], py.b[:, None]), CM31(py.c[:, None], py.d[:, None])
        ta = q.c_mul(CM31(m31.sub(prx.re, dom_x), prx.im), piy)
        tb = q.c_mul(CM31(m31.sub(pry.re, dom_y), pry.im), pix)
        denom_inv = q.c_inv(q.c_sub(ta, tb))

        acc = q.q_add(acc, q.q_mul_cm31(numerator, denom_inv))
    return acc
