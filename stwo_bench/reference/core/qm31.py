"""CM31 / QM31 extension fields over M31 on int64 tensors.

Twin of recursive_stwo_tpu/core/qm31.py, with the same structure-of-arrays
tuples (the CM31 / QM31 NamedTuples of the host copy, qm31_host.py):

  CM31 = M31[i] / (i**2 + 1)
  QM31 = CM31[u] / (u**2 - (2 + i)),  (a, b, c, d) = (a + b i) + (c + d i) u
"""

from __future__ import annotations

import torch

from . import m31
from .qm31_host import CM31, QM31


# ---------------------------------------------------------------------------
# CM31
# ---------------------------------------------------------------------------

def c_add(x: CM31, y: CM31) -> CM31:
    return CM31(m31.add(x.re, y.re), m31.add(x.im, y.im))


def c_sub(x: CM31, y: CM31) -> CM31:
    return CM31(m31.sub(x.re, y.re), m31.sub(x.im, y.im))


def c_neg(x: CM31) -> CM31:
    return CM31(m31.neg(x.re), m31.neg(x.im))


def c_mul(x: CM31, y: CM31) -> CM31:
    # (a+bi)(c+di) = (ac - bd) + (ad + bc)i
    return CM31(
        m31.sub(m31.mul(x.re, y.re), m31.mul(x.im, y.im)),
        m31.add(m31.mul(x.re, y.im), m31.mul(x.im, y.re)),
    )


def c_inv(x: CM31) -> CM31:
    # 1/(a+bi) = (a-bi)/(a**2+b**2)
    ninv = m31.inv(m31.add(m31.mul(x.re, x.re), m31.mul(x.im, x.im)))
    return CM31(m31.mul(x.re, ninv), m31.mul(m31.neg(x.im), ninv))


def _mul_by_2_plus_i(x: CM31) -> CM31:
    # (2+i)(re + im i) = (2re - im) + (2im + re) i
    return CM31(
        m31.sub(m31.add(x.re, x.re), x.im),
        m31.add(m31.add(x.im, x.im), x.re),
    )


# ---------------------------------------------------------------------------
# QM31
# ---------------------------------------------------------------------------

def q_add(x: QM31, y: QM31) -> QM31:
    return QM31(*(m31.add(u, v) for u, v in zip(x, y)))


def q_sub(x: QM31, y: QM31) -> QM31:
    return QM31(*(m31.sub(u, v) for u, v in zip(x, y)))


def q_neg(x: QM31) -> QM31:
    return QM31(*(m31.neg(u) for u in x))


def q_mul(x: QM31, y: QM31) -> QM31:
    # (p + q u)(r + s u) = pr + (2+i) qs + (ps + qr) u
    p, q = x.first, x.second
    r, s = y.first, y.second
    first = c_add(c_mul(p, r), _mul_by_2_plus_i(c_mul(q, s)))
    second = c_add(c_mul(p, s), c_mul(q, r))
    return QM31(first.re, first.im, second.re, second.im)


def q_mul_m31(x: QM31, s) -> QM31:
    return QM31(*(m31.mul(u, s) for u in x))


def q_mul_cm31(x: QM31, s: CM31) -> QM31:
    first = c_mul(x.first, s)
    second = c_mul(x.second, s)
    return QM31(first.re, first.im, second.re, second.im)


def q_inv(x: QM31) -> QM31:
    # 1/(p + q u) = (p - q u) / (p**2 - (2+i) q**2)
    p, q = x.first, x.second
    ninv = c_inv(c_sub(c_mul(p, p), _mul_by_2_plus_i(c_mul(q, q))))
    num = c_mul(p, ninv)
    den = c_mul(c_neg(q), ninv)
    return QM31(num.re, num.im, den.re, den.im)


def q_pow(x: QM31, e: int) -> QM31:
    if e < 0:
        raise ValueError(f"negative exponent {e}")
    result = None
    base = x
    while e > 0:
        if e & 1:
            result = base if result is None else q_mul(result, base)
        base = q_mul(base, base)
        e >>= 1
    if result is None:
        return q_one(x.a)
    return result


def q_zero(like: torch.Tensor) -> QM31:
    z = torch.zeros_like(like)
    return QM31(z, z, z, z)


def q_one(like: torch.Tensor) -> QM31:
    z = torch.zeros_like(like)
    return QM31(z + 1, z, z, z)


def q_shift_by_i(x: QM31) -> QM31:
    """Multiply by i: (a+bi) i = -b + ai, on both CM31 limbs."""
    return QM31(m31.neg(x.b), x.a, m31.neg(x.d), x.c)


def q_shift_by_j(x: QM31) -> QM31:
    """Multiply by u: (p + q u) u = (2+i) q + p u."""
    rq = _mul_by_2_plus_i(x.second)
    return QM31(rq.re, rq.im, x.a, x.b)


def q_shift_by_ij(x: QM31) -> QM31:
    return q_shift_by_j(q_shift_by_i(x))


def q_combine4(v0: QM31, v1: QM31, v2: QM31, v3: QM31) -> QM31:
    """v0 + v1*i + v2*u + v3*iu (stwo's combine_ef over 4 QM31 values)."""
    return q_add(
        q_add(v0, q_shift_by_i(v1)),
        q_add(q_shift_by_j(v2), q_shift_by_ij(v3)),
    )


def q_select(cond: torch.Tensor, x: QM31, y: QM31) -> QM31:
    """where(cond, x, y) component-wise."""
    return QM31(*(torch.where(cond, u, v) for u, v in zip(x, y)))
