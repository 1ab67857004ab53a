"""Scalar (python-int) M31 / CM31 / QM31 arithmetic for the gadget DSL.

The constraint-system builder executes eagerly on the host, one wire at a
time (mirroring the reference's eager `*Var` evaluation, e.g.
/root/reference/primitives/fields/src/m31.rs).  Python integers mod p are
the fastest host representation for that access pattern; the batched
uint32-array kernels in `core/` serve the device verifier instead.

A QM31 scalar is a 4-tuple (a, b, c, d) of ints meaning
(a + b*i) + (c + d*i)*u with i*i = -1 and u*u = 2 + i (stwo SecureField).
"""

from __future__ import annotations

P = (1 << 31) - 1

QZERO = (0, 0, 0, 0)
QONE = (1, 0, 0, 0)
QI = (0, 1, 0, 0)
QJ = (0, 0, 1, 0)


def q_from_m31(x: int):
    return (x % P, 0, 0, 0)


def q_add(x, y):
    return (
        (x[0] + y[0]) % P,
        (x[1] + y[1]) % P,
        (x[2] + y[2]) % P,
        (x[3] + y[3]) % P,
    )


def q_sub(x, y):
    return (
        (x[0] - y[0]) % P,
        (x[1] - y[1]) % P,
        (x[2] - y[2]) % P,
        (x[3] - y[3]) % P,
    )


def q_neg(x):
    return ((-x[0]) % P, (-x[1]) % P, (-x[2]) % P, (-x[3]) % P)


def c_mul(ar, ai, br, bi):
    return ((ar * br - ai * bi) % P, (ar * bi + ai * br) % P)


def q_mul(x, y):
    # (p + q*u)(r + s*u) = pr + (2+i) qs + (ps + qr) u
    pr = c_mul(x[0], x[1], y[0], y[1])
    qs = c_mul(x[2], x[3], y[2], y[3])
    ps = c_mul(x[0], x[1], y[2], y[3])
    qr = c_mul(x[2], x[3], y[0], y[1])
    first = (
        (pr[0] + 2 * qs[0] - qs[1]) % P,
        (pr[1] + 2 * qs[1] + qs[0]) % P,
    )
    return (first[0], first[1], (ps[0] + qr[0]) % P, (ps[1] + qr[1]) % P)


def q_mul_m31(x, s: int):
    return (x[0] * s % P, x[1] * s % P, x[2] * s % P, x[3] * s % P)


def q_inv(x):
    # 1/(p + q u) = conj / (p**2 - (2+i) q**2)
    p2 = c_mul(x[0], x[1], x[0], x[1])
    q2 = c_mul(x[2], x[3], x[2], x[3])
    nr = (p2[0] - 2 * q2[0] + q2[1]) % P
    ni = (p2[1] - 2 * q2[1] - q2[0]) % P
    # CM31 inverse of (nr, ni)
    norm = (nr * nr + ni * ni) % P
    w = pow(norm, P - 2, P)
    inr, ini = nr * w % P, (-ni) * w % P
    num = c_mul(x[0], x[1], inr, ini)
    den = c_mul((-x[2]) % P, (-x[3]) % P, inr, ini)
    return (num[0], num[1], den[0], den[1])


def q_pow(x, e: int):
    r = QONE
    b = x
    while e > 0:
        if e & 1:
            r = q_mul(r, b)
        b = q_mul(b, b)
        e >>= 1
    return r


def m_inv(x: int) -> int:
    return pow(x, P - 2, P)


def q_is_zero(x) -> bool:
    return x == QZERO
