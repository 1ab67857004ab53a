"""Host copy of recursive_stwo_tpu/core/qm31.py (numpy only; its jax branches are
removed).  The torch twin is qm31.py beside it.

CM31 / QM31 extension-field towers over M31, structure-of-arrays layout.

  CM31 = M31[i] / (i**2 + 1)
  QM31 = CM31[u] / (u**2 - (2 + i))        (stwo's SecureField)

A CM31 is a pair of same-shape uint32 arrays (re, im); a QM31 is a 4-tuple
(a, b, c, d) meaning (a + b*i) + (c + d*i)*u.  SoA keeps every component a
full-width VPU-friendly array instead of burning the 128-lane dimension on a
trailing axis of 4.

Reference semantics: stwo `core/fields/{cm31,qm31}.rs`; gadget mirrors in
recursive-stwo primitives/fields/src/{cm31,qm31}.rs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from . import m31_host as m31


class CM31(NamedTuple):
    re: object
    im: object


class QM31(NamedTuple):
    a: object  # first CM31 real
    b: object  # first CM31 imag
    c: object  # second CM31 real
    d: object  # second CM31 imag

    @property
    def first(self) -> CM31:
        return CM31(self.a, self.b)

    @property
    def second(self) -> CM31:
        return CM31(self.c, self.d)


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


def c_mul_m31(x: CM31, s) -> CM31:
    return CM31(m31.mul(x.re, s), m31.mul(x.im, s))


def c_inv(x: CM31) -> CM31:
    # 1/(a+bi) = (a-bi)/(a**2+b**2)
    norm = m31.add(m31.mul(x.re, x.re), m31.mul(x.im, x.im))
    ninv = m31.inv(norm)
    return CM31(m31.mul(x.re, ninv), m31.mul(m31.neg(x.im), ninv))


def c_zero(like=None):
    z = np.uint32(0) if like is None else like * np.uint32(0)
    return CM31(z, z)


# ---------------------------------------------------------------------------
# QM31
# ---------------------------------------------------------------------------

def q_from_m31(a, b=None, c=None, d=None) -> QM31:
    zero = a * np.uint32(0)
    return QM31(
        a,
        zero if b is None else b,
        zero if c is None else c,
        zero if d is None else d,
    )


def q_add(x: QM31, y: QM31) -> QM31:
    return QM31(
        m31.add(x.a, y.a), m31.add(x.b, y.b), m31.add(x.c, y.c), m31.add(x.d, y.d)
    )


def q_sub(x: QM31, y: QM31) -> QM31:
    return QM31(
        m31.sub(x.a, y.a), m31.sub(x.b, y.b), m31.sub(x.c, y.c), m31.sub(x.d, y.d)
    )


def q_neg(x: QM31) -> QM31:
    return QM31(m31.neg(x.a), m31.neg(x.b), m31.neg(x.c), m31.neg(x.d))


def q_mul(x: QM31, y: QM31) -> QM31:
    # (p + q*u)(r + s*u) = pr + (2+i) qs + (ps + qr) u ;   u**2 = 2 + i
    p, q = x.first, x.second
    r, s = y.first, y.second
    pr = c_mul(p, r)
    qs = c_mul(q, s)
    ps_qr = c_add(c_mul(p, s), c_mul(q, r))
    # (2+i) * qs = (2*re - im) + (2*im + re) i
    rqs = CM31(
        m31.sub(m31.add(qs.re, qs.re), qs.im),
        m31.add(m31.add(qs.im, qs.im), qs.re),
    )
    first = c_add(pr, rqs)
    return QM31(first.re, first.im, ps_qr.re, ps_qr.im)


def q_mul_m31(x: QM31, s) -> QM31:
    return QM31(m31.mul(x.a, s), m31.mul(x.b, s), m31.mul(x.c, s), m31.mul(x.d, s))


def q_mul_cm31(x: QM31, s: CM31) -> QM31:
    first = c_mul(x.first, s)
    second = c_mul(x.second, s)
    return QM31(first.re, first.im, second.re, second.im)


def q_inv(x: QM31) -> QM31:
    # 1/(p + q u) = (p - q u) / (p**2 - (2+i) q**2)
    p, q = x.first, x.second
    p2 = c_mul(p, p)
    q2 = c_mul(q, q)
    rq2 = CM31(
        m31.sub(m31.add(q2.re, q2.re), q2.im),
        m31.add(m31.add(q2.im, q2.im), q2.re),
    )
    norm = c_sub(p2, rq2)
    ninv = c_inv(norm)
    num = c_mul(p, ninv)
    den = c_mul(c_neg(q), ninv)
    return QM31(num.re, num.im, den.re, den.im)


def q_pow(x: QM31, e: int) -> QM31:
    assert e >= 0
    result = None
    base = x
    while e > 0:
        if e & 1:
            result = base if result is None else q_mul(result, base)
        base = q_mul(base, base)
        e >>= 1
    if result is None:
        return q_from_m31(x.a * np.uint32(0) + np.uint32(1))
    return result


def q_zero(like=None) -> QM31:
    z = np.uint32(0) if like is None else like * np.uint32(0)
    return QM31(z, z, z, z)


def q_one(like=None) -> QM31:
    z = np.uint32(0) if like is None else like * np.uint32(0)
    return QM31(z + np.uint32(1), z, z, z)


def q_shift_by_i(x: QM31) -> QM31:
    """Multiply by i = (0,1,0,0): (a+bi) i = -b + ai ; same on second limb."""
    return QM31(m31.neg(x.b), x.a, m31.neg(x.d), x.c)


def q_shift_by_j(x: QM31) -> QM31:
    """Multiply by u = (0,0,1,0): (p + q u) u = (2+i) q + p u."""
    rq = CM31(
        m31.sub(m31.add(x.c, x.c), x.d),
        m31.add(m31.add(x.d, x.d), x.c),
    )
    return QM31(rq.re, rq.im, x.a, x.b)


def q_shift_by_ij(x: QM31) -> QM31:
    return QM31(*q_shift_by_j(q_shift_by_i(x)))


def q_combine4(v0: QM31, v1: QM31, v2: QM31, v3: QM31) -> QM31:
    """v0 + v1*i + v2*u + v3*iu  (stwo's combine_ef over 4 QM31 values)."""
    return q_add(
        q_add(v0, q_shift_by_i(v1)),
        q_add(q_shift_by_j(v2), q_shift_by_ij(v3)),
    )


def q_select(cond, x: QM31, y: QM31, where_fn) -> QM31:
    """where(cond, x, y) component-wise; where_fn = np.where."""
    return QM31(
        where_fn(cond, x.a, y.a),
        where_fn(cond, x.b, y.b),
        where_fn(cond, x.c, y.c),
        where_fn(cond, x.d, y.d),
    )


# Host-side conversion helpers -------------------------------------------------

def q_scalar(a: int, b: int, c: int, d: int) -> QM31:
    return QM31(np.uint32(a), np.uint32(b), np.uint32(c), np.uint32(d))


def q_to_tuple(x: QM31):
    return (int(x.a), int(x.b), int(x.c), int(x.d))
