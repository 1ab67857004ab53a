"""Host copy of recursive_stwo_tpu/core/m31.py (numpy only; its jax branches are
removed).  The torch twin is m31.py beside it.

M31 (Mersenne-31) field arithmetic, array-first and backend-agnostic.

The base field is F_p with p = 2**31 - 1.  Values are stored as uint32 arrays
in canonical range [0, p).  Every op below is written against the common
subset of numpy / jax.numpy uint32 semantics (wraparound mod 2**32), so the
same code path runs

  * on host (numpy) for hint preparation / proof parsing, and
  * on TPU (jax.numpy) inside jit-compiled verifier kernels (in the JAX
    package only).

Multiplication uses a 16-bit limb split so that no intermediate exceeds
32 bits: TPU has no native 32x32->64 multiply, and keeping everything in
uint32 maps directly onto the VPU (8x128 lanes).

Reference semantics: stwo `core/fields/m31.rs` (external dep of
recursive-stwo; see recursive-stwo primitives/fields/src/m31.rs for the
gadget-level mirror).
"""

from __future__ import annotations

import numpy as np

P = np.uint32(2147483647)  # 2**31 - 1
MASK31 = np.uint32(0x7FFFFFFF)
MASK16 = np.uint32(0xFFFF)
MASK15 = np.uint32(0x7FFF)


def _as_u32(x):
    """Coerce python ints to uint32 scalars; leave arrays untouched."""
    if isinstance(x, (int, np.integer)):
        return np.uint32(x)
    return x


def _native_binop(a, b, name):
    """No native kernel in the reference: numpy always."""
    return None


def add(a, b):
    """(a + b) mod p.  a, b in [0, p) => a+b < 2**32 with no wrap issues."""
    out = _native_binop(a, b, "m31_add_batch")
    if out is not None:
        return out
    return reduce_once(_as_u32(a) + _as_u32(b))


def neg(a):
    # p - a in (0, p], then canonicalize so that a == 0 maps back to 0.
    return reduce_once(P - _as_u32(a))


def sub(a, b):
    out = _native_binop(a, b, "m31_sub_batch")
    if out is not None:
        return out
    # a + (p - b), both summands < 2**31 so the uint32 sum cannot wrap.
    s = _as_u32(a) + (P - _as_u32(b))
    s = (s & MASK31) + (s >> np.uint32(31))
    return reduce_once(s)


def _partial_reduce(t):
    """Reduce t < 2**32 to < 2**31 using 2**31 == 1 (mod p).  Result may be p."""
    return (t & MASK31) + (t >> np.uint32(31))


def reduce_once(t):
    """Canonicalize a value in [0, 2p-2] to [0, p).

    numpy path: the mask-multiply `t - (t >= P) * P`."""
    return t - (t >= P) * P


def mul(a, b):
    """(a * b) mod p via 16-bit limbs; all intermediates fit in uint32."""
    a, b = _as_u32(a), _as_u32(b)
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        size = a.size if isinstance(a, np.ndarray) else b.size
        if size <= (1 << 10):
            # small arrays are numpy-call-overhead bound: one u64 widening
            # product + one division beats ~15 limb-split ops
            return (
                (np.asarray(a, np.uint64) * np.asarray(b, np.uint64)) % P
            ).astype(np.uint32)
    a0 = a & MASK16
    a1 = a >> np.uint32(16)  # < 2**15
    b0 = b & MASK16
    b1 = b >> np.uint32(16)  # < 2**15

    m0 = a0 * b0  # < 2**32
    m1 = a0 * b1 + a1 * b0  # < 2**32
    m3 = a1 * b1  # < 2**30

    # value = m3*2**32 + m1*2**16 + m0  (mod p): 2**31 == 1, 2**32 == 2.
    t0 = (m0 & MASK31) + (m0 >> np.uint32(31))  # <= 2**31
    t1 = ((m1 & MASK15) << np.uint32(16)) + (m1 >> np.uint32(15))  # < 2**31 + 2**17
    t1 = (t1 & MASK31) + (t1 >> np.uint32(31))
    t2 = m3 + m3  # < 2**31

    r = t0 + t1  # < 2**32
    r = (r & MASK31) + (r >> np.uint32(31))
    r = r + t2
    r = (r & MASK31) + (r >> np.uint32(31))
    return reduce_once(r)


def double(a):
    return add(a, a)


def pow_const(a, e: int):
    """a**e for a python-int exponent (unrolled square-and-multiply)."""
    assert e >= 0
    result = None
    base = a
    while e > 0:
        if e & 1:
            result = base if result is None else mul(result, base)
        base = mul(base, base)
        e >>= 1
    if result is None:
        return a * np.uint32(0) + np.uint32(1)
    return result


def inv(a):
    """a**(p-2); p-2 = 2**31 - 3.

    numpy path: short addition chain (~37 muls)."""
    t0 = mul(pow2k(a, 2), a)   # a**5
    t1 = mul(pow2k(t0, 1), t0)  # a**15
    t2 = mul(pow2k(t1, 3), t0)  # a**125
    t3 = mul(pow2k(t2, 1), t0)  # a**255
    t4 = mul(pow2k(t3, 8), t3)  # a**65535
    t5 = mul(pow2k(t4, 8), t3)  # a**16777215
    return mul(pow2k(t5, 7), t2)  # a**(2**31-3)


def pow2k(a, k: int):
    for _ in range(k):
        a = mul(a, a)
    return a


def m31_from_i64(v: int) -> int:
    """Host helper: python int (possibly negative) -> canonical M31 residue."""
    return int(v % 2147483647)
