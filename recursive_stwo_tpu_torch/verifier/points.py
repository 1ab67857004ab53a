"""Batched circle-point computations for the verifier.

Twin of recursive_stwo_tpu/verifier/points.py: the OODS point from the
transcript draw, the per-query "half-index point" chain A_L(q) shared by every
log size, column-domain points, and the canonic-coset vanishing polynomial.
The reference's `lax.scan`s are Python loops here.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..core import circle_host as circle
from ..core import m31
from ..core import qm31 as q
from ..core.circle import apoint_add_const
from ..core.circle_host import Coset
from ..core.qm31 import QM31
from .points_host import _J
from .spec import VerifierSpec


def oods_point_from_t(t: QM31) -> Tuple[QM31, QM31]:
    """Stereographic map t -> ((1-t^2)/(1+t^2), 2t/(1+t^2))."""
    t2 = q.q_mul(t, t)
    one = q.q_one(t.a)
    inv = q.q_inv(q.q_add(t2, one))
    return q.q_mul(q.q_sub(one, t2), inv), q.q_mul(q.q_add(t, t), inv)


def add_constant_point(p: Tuple[QM31, QM31], c: Tuple[int, int]) -> Tuple[QM31, QM31]:
    """(x, y) + constant M31 point, QM31 coordinates."""
    x, y = p
    cx, cy = int(c[0]), int(c[1])
    nx = q.q_sub(q.q_mul_m31(x, cx), q.q_mul_m31(y, cy))
    ny = q.q_add(q.q_mul_m31(x, cy), q.q_mul_m31(y, cx))
    return nx, ny


def shifted_oods_point(
    oods: Tuple[QM31, QM31], shift: int, trace_log_size: int
) -> Tuple[QM31, QM31]:
    """oods + shift * CanonicCoset(trace_log_size).step()."""
    if shift == 0:
        return oods
    step_index = circle.subgroup_gen_index(trace_log_size)
    return add_constant_point(
        oods, circle.point_at_index((shift * step_index) % (1 << 31))
    )


def _cond_add_const(x, y, bit, c):
    """(x, y) + c where bit != 0, else (x, y)."""
    ax, ay = apoint_add_const((x, y), c)
    cond = bit != 0
    return torch.where(cond, ax, x), torch.where(cond, ay, y)


def half_index_points(
    spec: VerifierSpec, raw_queries: torch.Tensor, min_log: int
) -> Dict[int, Tuple[torch.Tensor, torch.Tensor]]:
    """A_L(q_L) for every L in [min_log, max_first_layer_log], batched.

    raw_queries: (B, Q); returns dict L -> (x, y), each (B, Q)."""
    M = spec.max_first_layer_log
    qmax = raw_queries & ((1 << M) - 1)

    init = Coset.half_odds(M).initial
    x = torch.full_like(qmax, init[0])
    y = torch.full_like(qmax, init[1])
    # A_M = initial + sum_{k=1}^{M-1} bit_k * point(2**(30-k))
    for k in range(1, M):
        x, y = _cond_add_const(
            x, y, (qmax >> k) & 1, circle.point_at_index(1 << (30 - k))
        )

    out = {M: (x, y)}
    # A_{L-1}(q >> 1) = double(A_L + bit_1 * J), bit_1 of q_{L+1} = bit (M-L) of qmax
    for L in range(M - 1, min_log - 1, -1):
        x, y = _cond_add_const(x, y, (qmax >> (M - L)) & 1, _J)
        x, y = m31.sub(m31.mul(x, x), m31.mul(y, y)), m31.double(m31.mul(x, y))
        out[L] = (x, y)
    return out


def domain_point(half_pt, queries_at_log):
    """Column-domain point at this log size: 2*A, y negated iff bit0.

    Returns (x, y, y before the negation)."""
    ax, ay = half_pt
    dx = m31.sub(m31.mul(ax, ax), m31.mul(ay, ay))
    dy = m31.double(m31.mul(ax, ay))
    bit0 = (queries_at_log & 1) != 0
    return dx, torch.where(bit0, m31.neg(dy), dy), dy


def repeated_double_x(x: QM31, n: int) -> QM31:
    for _ in range(n):
        sq = q.q_mul(x, x)
        x = q.q_sub(q.q_add(sq, sq), q.q_one(x.a))
    return x


def coset_vanishing_canonic(oods_x: QM31, log_size: int) -> QM31:
    """Vanishing polynomial of CanonicCoset(log_size) at a point with
    x-coordinate oods_x: pi applied (log_size - 1) times."""
    return repeated_double_x(oods_x, log_size - 1)
