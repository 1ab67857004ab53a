"""Host copy of recursive_stwo_tpu/core/circle.py (numpy only; its jax branches are
removed).

Circle group over M31: x**2 + y**2 = 1, |G| = 2**31.

Host-side (python int) point/coset machinery for building static tables, plus
SoA array ops for device-side batched point arithmetic.

Semantics follow stwo `core/circle.rs` / `core/poly/circle/{canonic,domain}.rs`
(external dep of recursive-stwo; indexing behavior cross-checked against the
gadget test recursive-stwo primitives/circle/src/lib.rs:263-285).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

from . import m31_host as m31

P = 2147483647
M31_CIRCLE_LOG_ORDER = 31
# Generator of the full circle group of order 2**31 (stwo M31_CIRCLE_GEN).
M31_CIRCLE_GEN = (2, 1268011823)


# ---------------------------------------------------------------------------
# Host-side scalar points (python ints)
# ---------------------------------------------------------------------------

def point_add(p, q):
    x1, y1 = p
    x2, y2 = q
    return ((x1 * x2 - y1 * y2) % P, (x1 * y2 + y1 * x2) % P)


def point_neg(p):
    return (p[0], (-p[1]) % P)


def point_double(p):
    return point_add(p, p)


POINT_IDENTITY = (1, 0)


@lru_cache(maxsize=None)
def _gen_power_of_two(k: int):
    """M31_CIRCLE_GEN * 2**k."""
    p = M31_CIRCLE_GEN
    for _ in range(k):
        p = point_double(p)
    return p


def point_at_index(index: int):
    """Scalar mul: M31_CIRCLE_GEN * index, index in [0, 2**31)."""
    index %= 1 << M31_CIRCLE_LOG_ORDER
    acc = POINT_IDENTITY
    k = 0
    while index:
        if index & 1:
            acc = point_add(acc, _gen_power_of_two(k))
        index >>= 1
        k += 1
    return acc


def subgroup_gen_index(log_size: int) -> int:
    assert log_size <= M31_CIRCLE_LOG_ORDER
    return 1 << (M31_CIRCLE_LOG_ORDER - log_size)


def bit_reverse_index(i: int, bits: int) -> int:
    return int(format(i, f"0{bits}b")[::-1], 2) if bits > 0 else 0


@dataclass(frozen=True)
class Coset:
    """Arithmetic progression of point indices: initial + i*step, 2**log_size pts."""

    initial_index: int
    log_size: int

    @property
    def step_index(self) -> int:
        return subgroup_gen_index(self.log_size)

    @property
    def size(self) -> int:
        return 1 << self.log_size

    def index_at(self, i: int) -> int:
        return (self.initial_index + i * self.step_index) % (1 << M31_CIRCLE_LOG_ORDER)

    def at(self, i: int):
        return point_at_index(self.index_at(i))

    @property
    def initial(self):
        return point_at_index(self.initial_index)

    @property
    def step(self):
        return point_at_index(self.step_index)

    @staticmethod
    def odds(log_size: int) -> "Coset":
        return Coset(subgroup_gen_index(log_size + 1), log_size)

    @staticmethod
    def half_odds(log_size: int) -> "Coset":
        return Coset(subgroup_gen_index(log_size + 2), log_size)

    @staticmethod
    def subgroup(log_size: int) -> "Coset":
        return Coset(0, log_size)


@dataclass(frozen=True)
class CircleDomain:
    """half_coset union its conjugate; |domain| = 2 * |half_coset|."""

    half_coset: Coset

    @property
    def log_size(self) -> int:
        return self.half_coset.log_size + 1

    @property
    def size(self) -> int:
        return 1 << self.log_size

    def index_at(self, i: int) -> int:
        half = self.half_coset.size
        if i < half:
            return self.half_coset.index_at(i)
        return (-self.half_coset.index_at(i - half)) % (1 << M31_CIRCLE_LOG_ORDER)

    def at(self, i: int):
        return point_at_index(self.index_at(i))


@dataclass(frozen=True)
class CanonicCoset:
    log_size: int

    @property
    def coset(self) -> Coset:
        return Coset.odds(self.log_size)

    def circle_domain(self) -> CircleDomain:
        return CircleDomain(Coset.half_odds(self.log_size - 1))

    def step(self):
        return self.coset.step


# ---------------------------------------------------------------------------
# Device-side batched point ops: a point is a pair (x, y) of uint32 arrays
# ---------------------------------------------------------------------------

def apoint_add(p, q):
    x1, y1 = p
    x2, y2 = q
    return (
        m31.sub(m31.mul(x1, x2), m31.mul(y1, y2)),
        m31.add(m31.mul(x1, y2), m31.mul(y1, x2)),
    )


def apoint_add_const(p, c):
    """Add a constant scalar point c=(int,int) to a batched point."""
    import numpy as np

    x1, y1 = p
    cx, cy = np.uint32(c[0]), np.uint32(c[1])
    return (
        m31.sub(m31.mul(x1, cx), m31.mul(y1, cy)),
        m31.add(m31.mul(x1, cy), m31.mul(y1, cx)),
    )


def apoint_double_x(x):
    """pi(x) = 2x**2 - 1, the x-projection of point doubling."""
    import numpy as np

    sq = m31.mul(x, x)
    return m31.sub(m31.add(sq, sq), np.uint32(1))


def bit_reverse_indices(n_bits: int):
    """Vectorized bit_reverse_index for all i in [0, 2^n_bits)."""
    import numpy as np

    i = np.arange(1 << n_bits, dtype=np.uint32)
    r = np.zeros_like(i)
    for k in range(n_bits):
        r |= ((i >> np.uint32(k)) & np.uint32(1)) << np.uint32(n_bits - 1 - k)
    return r.astype(np.int64)


def apoints_at_indices(indices):
    """Vectorized point_at_index over a uint32/int index array."""
    import numpy as np

    idx = np.asarray(indices, dtype=np.uint64)
    x = np.full(idx.shape, np.uint32(1))
    y = np.zeros(idx.shape, np.uint32)
    for k in range(M31_CIRCLE_LOG_ORDER):
        gx, gy = _gen_power_of_two(k)
        bit = ((idx >> np.uint64(k)) & np.uint64(1)).astype(bool)
        nx = m31.sub(m31.mul(x, np.uint32(gx)), m31.mul(y, np.uint32(gy)))
        ny = m31.add(m31.mul(x, np.uint32(gy)), m31.mul(y, np.uint32(gx)))
        x = np.where(bit, nx, x)
        y = np.where(bit, ny, y)
    return x, y
