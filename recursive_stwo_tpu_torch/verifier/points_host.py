"""Host copy of recursive_stwo_tpu/verifier/points.py (numpy only; its jax branches are
removed).  The torch twin is points.py beside it.

Batched circle-point computations for the verifier.

Query -> domain point uses the "half-index point" chain: with
A_L(q) = point at index 2**(29-L) + sum_{k>=1} bit_k(q) * 2**(30-k)
(a point of Coset::half_odds(L)), the column domain point at log size L is
2*A_L(q) negated iff bit_0(q), and A_{L-1}(q>>1) = double(A_L + bit_1(q)*J)
with the constant J = -(gen * 2**29).  One descending chain serves every log
size (mirrors PointCarryingQueryVar::new/next,
/root/reference/primitives/query/src/lib.rs:56-164).

OODS/mask math mirrors hints/fiat_shamir.rs:138-155 and
recursive/answer/src/lib.rs:62-101.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..core import circle_host as circle, m31_host as m31
from ..core import qm31_host as q
from ..core.circle_host import Coset
from ..core.qm31_host import QM31
from .spec import VerifierSpec

# J = -(M31_CIRCLE_GEN * 2**29), the constant step eliminated by next().
_J = circle.point_neg(circle.point_at_index(1 << 29))


def oods_point_from_t(t: QM31) -> Tuple[QM31, QM31]:
    """Stereographic map t -> ((1-t^2)/(1+t^2), 2t/(1+t^2))."""
    t2 = q.q_mul(t, t)
    one = q.q_one(t.a)
    inv = q.q_inv(q.q_add(t2, one))
    x = q.q_mul(q.q_sub(one, t2), inv)
    y = q.q_mul(q.q_add(t, t), inv)
    return x, y


def add_constant_point(p: Tuple[QM31, QM31], c: Tuple[int, int]) -> Tuple[QM31, QM31]:
    """(x, y) + constant M31 point, QM31 coordinates."""
    x, y = p
    cx, cy = np.uint32(c[0]), np.uint32(c[1])
    nx = q.q_sub(q.q_mul_m31(x, cx), q.q_mul_m31(y, cy))
    ny = q.q_add(q.q_mul_m31(x, cy), q.q_mul_m31(y, cx))
    return nx, ny


def shifted_oods_point(
    oods: Tuple[QM31, QM31], shift: int, trace_log_size: int
) -> Tuple[QM31, QM31]:
    """oods + shift * CanonicCoset(trace_log_size).step()  (shift in {-1,0,..})."""
    if shift == 0:
        return oods
    step_index = circle.subgroup_gen_index(trace_log_size)
    cpt = circle.point_at_index((shift * step_index) % (1 << 31))
    return add_constant_point(oods, cpt)


def _where(xp, cond, a, b):
    return xp.where(cond, a, b)


def _xp(arr):
    return np


def _cond_add_const(xp, x, y, bit, c):
    """(x,y) + c if bit else (x,y); bit is a {0,1} uint array."""
    ax, ay = circle.apoint_add_const((x, y), c)
    return _where(xp, bit != 0, ax, x), _where(xp, bit != 0, ay, y)


def half_index_points(
    spec: VerifierSpec, raw_queries, min_log: int
) -> Dict[int, Tuple[object, object]]:
    """A_L(q_L) for every L in [min_log, max_first_layer_log], batched.

    raw_queries: (B, Q) uint32; returns dict L -> (x, y) each (B, Q).
    """
    xp = _xp(raw_queries)
    M = spec.max_first_layer_log
    qmax = raw_queries & np.uint32((1 << M) - 1)

    coset = Coset.half_odds(M)
    # derive from qmax (not a fresh constant) so varying-axes metadata
    # survives shard_map check_vma through the scans below
    zero = qmax * np.uint32(0)
    x = zero + np.uint32(coset.initial[0])
    y = zero + np.uint32(coset.initial[1])

    # A_M = initial + sum_{k=1}^{M-1} bit_k * point(2**(30-k))
    consts = np.array(
        [circle.point_at_index(1 << (30 - k)) for k in range(1, M)], np.uint32
    )
    bits_k = [(qmax >> np.uint32(k)) & np.uint32(1) for k in range(1, M)]
    for k in range(M - 1):
        x, y = _cond_add_const(xp, x, y, bits_k[k], tuple(consts[k]))

    out = {M: (x, y)}
    n_down = M - min_log
    if n_down > 0:
        # bit_1 of q_{L+1} = bit (M - L) of qmax   (q_{L+1} = qmax >> (M-L-1))
        bits1 = [
            (qmax >> np.uint32(M - L)) & np.uint32(1)
            for L in range(M - 1, min_log - 1, -1)
        ]
        jx, jy = np.uint32(_J[0]), np.uint32(_J[1])

        def down_body(carry, bit):
            px, py = carry
            ax = m31.sub(m31.mul(px, jx), m31.mul(py, jy))
            ay = m31.add(m31.mul(px, jy), m31.mul(py, jx))
            cond = (bit != 0)
            px = xp.where(cond, ax, px)
            py = xp.where(cond, ay, py)
            nx = m31.sub(m31.mul(px, px), m31.mul(py, py))
            ny = m31.double(m31.mul(px, py))
            return (nx, ny), (nx, ny)

        carry = (x, y)
        ys = []
        for b in bits1:
            carry, o = down_body(carry, b)
            ys.append(o)
        for i, L in enumerate(range(M - 1, min_log - 1, -1)):
            out[L] = ys[i]
    return out


def domain_point(half_pt, queries_at_log):
    """Column-domain point at this log size: 2*A, y negated iff bit0."""
    xp = _xp(queries_at_log)
    ax, ay = half_pt
    dx = m31.sub(m31.mul(ax, ax), m31.mul(ay, ay))
    dy = m31.double(m31.mul(ax, ay))
    bit0 = (queries_at_log & np.uint32(1)) != 0
    return dx, _where(xp, bit0, m31.neg(dy), dy), dy


def repeated_double_x(x: QM31, n: int) -> QM31:
    if n == 0:
        return x
    for _ in range(n):
        sq = q.q_mul(x, x)
        x = q.q_sub(q.q_add(sq, sq), q.q_one(x.a))
    return x


def coset_vanishing_canonic(oods_x: QM31, log_size: int) -> QM31:
    """Vanishing poly of CanonicCoset(log_size) at a point with x-coord
    oods_x: pi applied (log_size - 1) times (composition/src/lib.rs:18-29;
    the initial offset cancels for canonic cosets)."""
    return repeated_double_x(oods_x, log_size - 1)
