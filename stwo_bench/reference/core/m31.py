"""M31 (p = 2**31 - 1) arithmetic on int64 tensors.

Twin of recursive_stwo_tpu/core/m31.py.  Values are canonical residues in
[0, p) held in torch.int64, so a product of two residues (< 2**62) is exact
and one `%` brings any sum, difference or product back to canonical form;
the reference's 16-bit limb chain and uint32 wraparound are not needed.
Every function returns canonical values for canonical inputs; one operand
may be a python int.
"""

from __future__ import annotations

P = 2147483647


def add(a, b):
    return (a + b) % P


def sub(a, b):
    # torch's % takes the sign of the divisor, so a - b in (-p, p) lands in [0, p)
    return (a - b) % P


def neg(a):
    return (-a) % P


def mul(a, b):
    return (a * b) % P


def double(a):
    return add(a, a)


def pow2k(a, k: int):
    for _ in range(k):
        a = mul(a, a)
    return a


def pow_const(a, e: int):
    """a**e for a python-int exponent (square-and-multiply)."""
    if e < 0:
        raise ValueError(f"negative exponent {e}")
    result = None
    base = a
    while e > 0:
        if e & 1:
            result = base if result is None else mul(result, base)
        base = mul(base, base)
        e >>= 1
    if result is None:
        return a * 0 + 1
    return result


def inv(a):
    """a**(p-2) by the reference's addition chain (m31.py:171-177); inv(0) = 0."""
    t0 = mul(pow2k(a, 2), a)  # a**5
    t1 = mul(pow2k(t0, 1), t0)  # a**15
    t2 = mul(pow2k(t1, 3), t0)  # a**125
    t3 = mul(pow2k(t2, 1), t0)  # a**255
    t4 = mul(pow2k(t3, 8), t3)  # a**65535
    t5 = mul(pow2k(t4, 8), t3)  # a**16777215
    return mul(pow2k(t5, 7), t2)  # a**(2**31-3)
