"""ctypes wrappers of the provers' FRI fold-layer and last-layer kernels
(csrc/fri_fold.cu).

  fold_layer(g, join, alpha, log_size) -> (4, 2**(log_size - 1)) int64
      the next FRI layer's accumulator from a layer of 2**log_size points:
      fold_line(g) (g alone), fold_circle(join) (join alone: the first
      layer), or alpha**2 fold_line(g) + fold_circle(join), in one launch.
      The twin of what XLA compiled from
      recursive_stwo_tpu/prover/device_prove.py `_fold_line_jit` (:572-589)
      and the fold of `_join_commit_jit` (:593-623), and of
      recursive_stwo_tpu/prover/stream.py `_line_fold_jit` (:704-725) and
      `_join_fold_jit` (:667-701).

It takes CUDA int64 tensors of canonical residues and raises on anything
else; the plain version is prover/fri.py `fold_layer_plain`.  alpha is a
QM31 of python ints; it and alpha**2 reach the kernel as scalars by value,
never as tensors.  The kernel derives each pair's point from two small
tables a domain (`point_table`, cached on the device: the tile bases and a
tile's even table points of prover/tiles.py at tile log `split_log(n)`) and
inverts its x or y in registers.  A call launches the kernel once on the
current stream of its tensors' device, without synchronising, and writes a
new contiguous output.  `LAUNCHES` counts the launches.

  last_layer(g, tw, level, bound) -> (4 * 2**bound + 4,) int64
      the last layer's interpolation and degree check in one launch: the
      2**bound kept coefficients as (2**bound, 4) rows in the verifier's
      order, then each column's count of nonzero coefficients outside them.
      tw is prover/fri_last.py `twiddles(level, device)`; the plain version
      is fri_last.py `last_layer_poly_plain`, and fri_last.last_layer_poly
      reads the output back in one copy.

Limits (ValueError past them, never a truncation): 1 <= log_size <= MAX_LOG;
g and join (4, 2**log_size) int64, contiguous, 16-byte aligned, on one CUDA
device; at least one of them.  The last layer: 1 <= level <= MAX_LAST_LOG,
0 <= bound <= level, g (4, 2**level) int64 and contiguous, tw
(2**level - 1,) int64 and contiguous, both on one CUDA device.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..cs import scalar
from ..prover import tiles
from ..prover.arrays import to_device
from . import build
from .poseidon_cuda import H100_BYTES_PER_S, H100_INT_OPS_PER_S, _raise_on

P = 2**31 - 1
LAUNCHES = {"fri_fold": 0, "fri_last": 0}
MAX_LOG = 30  # 2**29 outputs: 4 x 2**30 int64 words a layer input, 32 GiB
MAX_LAST_LOG = 23  # slabs of 2**13 words, then tiles of 2**10 rows of 8 columns


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def split_log(log_size: int) -> int:
    """The tile log b of a fold of 2**log_size points: ceil(log_size / 2),
    so the bases (2**(n - b)) and the table's even points (2**(b - 1)) are
    both about 2**(n / 2)."""
    return max(1, (log_size + 1) // 2)


def host_table(log_size: int, line: bool) -> np.ndarray:
    """[bx, by, tx, ty] int64: the 2**(n - b) tile bases of the line domain
    half_odds(n) (line) or the circle domain of log n, then the even entries
    of its tile table of 2**b (prover/tiles.py), b = split_log(n)."""
    b = split_log(log_size)
    bx, by = (tiles.line_tile_bases if line else tiles.circle_tile_bases)(log_size, b)
    tx, ty = (tiles.line_tile_table if line else tiles.circle_tile_table)(log_size, b)
    return np.concatenate([bx, by, tx[0::2], ty[0::2]]).astype(np.int64)


@lru_cache(maxsize=None)
def point_table(log_size: int, line: bool, device: torch.device) -> torch.Tensor:
    """host_table on `device`, uploaded once."""
    return to_device(host_table(log_size, line), device)


def _limbs(alpha) -> list:
    limbs = [int(v) for v in alpha]
    if len(limbs) != 4 or not all(0 <= v < P for v in limbs):
        raise ValueError(f"expected alpha as four canonical M31 limbs, got {limbs}")
    return limbs


def check_layer(g, join, log_size: int) -> torch.device:
    """The inputs' device; raises ValueError past the kernel's limits."""
    if g is None and join is None:
        raise ValueError("a fold layer needs g, the join or both")
    if not 1 <= log_size <= MAX_LOG:
        raise ValueError(f"the fold-layer kernel takes 2**n points, 1 <= n <= {MAX_LOG}; got n = {log_size}")
    dev = (g if g is not None else join).device
    for x, name in ((g, "g"), (join, "join")):
        if x is None:
            continue
        if x.dim() != 2 or tuple(x.shape) != (4, 1 << log_size) or x.dtype != torch.int64:
            raise ValueError(f"expected {name} as (4, 2**{log_size}) int64, got {tuple(x.shape)} {x.dtype}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"expected {name} contiguous and 16-byte aligned (a pair is one 16-byte load)")
        if x.device != dev or dev.type != "cuda":
            raise ValueError(f"expected g and the join on one CUDA device, got {name} on {x.device}")
    return dev


def fold_layer(g, join, alpha, log_size: int) -> torch.Tensor:
    """The next layer's accumulator on the card (see the module docstring)."""
    a = _limbs(alpha)
    dev = check_layer(g, join, log_size)
    alphas = a + _limbs(scalar.q_mul(tuple(a), tuple(a)))
    out = torch.empty((4, 1 << (log_size - 1)), dtype=torch.int64, device=dev)
    line_tab = point_table(log_size, True, dev) if g is not None else None
    circle_tab = point_table(log_size, False, dev) if join is not None else None
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fri_fold_layer(*(None if x is None else x.data_ptr() for x in (g, join)), out.data_ptr(), log_size,
                                 *(None if x is None else x.data_ptr() for x in (line_tab, circle_tab)),
                                 split_log(log_size), (ctypes.c_int64 * 8)(*alphas), stream)
    _raise_on(err, "fri_fold_layer")
    LAUNCHES["fri_fold"] += 1
    return out


def check_last(g, tw, level: int, bound: int) -> torch.device:
    """g's device; raises ValueError past the last-layer kernel's limits."""
    if not 1 <= level <= MAX_LAST_LOG:
        raise ValueError(f"the last-layer kernel takes 2**n points, 1 <= n <= {MAX_LAST_LOG}; got n = {level}")
    if not 0 <= bound <= level:
        raise ValueError(f"the last-layer kernel keeps 2**bound coefficients, 0 <= bound <= {level}; got {bound}")
    for x, name, shape in ((g, "g", (4, 1 << level)), (tw, "tw", ((1 << level) - 1,))):
        if tuple(x.shape) != shape or x.dtype != torch.int64 or not x.is_contiguous():
            raise ValueError(f"expected {name} as a contiguous {shape} int64, got {tuple(x.shape)} {x.dtype}")
        if x.device != g.device or x.device.type != "cuda":
            raise ValueError(f"expected g and tw on one CUDA device, got {name} on {x.device}")
    return g.device


def last_layer(g: torch.Tensor, tw: torch.Tensor, level: int, bound: int) -> torch.Tensor:
    """The kept coefficients and the counts on the card (see the module
    docstring)."""
    dev = check_last(g, tw, level, bound)
    scratch = torch.empty((4, 1 << level), dtype=torch.int32, device=dev)
    out = torch.empty((4 << bound) + 4, dtype=torch.int64, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fri_last_layer(g.data_ptr(), tw.data_ptr(), scratch.data_ptr(), out.data_ptr(), level, bound,
                                 pow(2, -level, P), stream)
    _raise_on(err, "fri_last_layer")
    LAUNCHES["fri_last"] += 1
    return out


# ---------------------------------------------------------------------------
# bound: every input word read once (g, the join, both point tables) and
# every output word written once, against the int32 operations of an output
# counted as ops/composition_cuda counts them (an add or subtract 3, a
# product 6): a fold's point (2 products and an add), inverse (37
# products), l + r, l - r, the product by the inverse, by alpha (16 products,
# 16 adds) and the last add; with both inputs the product by alpha**2 and
# the sum.
# ---------------------------------------------------------------------------

ADD, MUL = 3, 6
Q_MUL = 16 * MUL + 16 * ADD
FOLD_OPS = (2 * MUL + ADD) + 37 * MUL + 4 * ADD + 4 * ADD + 4 * MUL + Q_MUL + 4 * ADD
JOIN_OPS = Q_MUL + 4 * ADD


def layer_ops(log_size: int, line: bool, circle: bool) -> int:
    per = FOLD_OPS * (line + circle) + (JOIN_OPS if line and circle else 0)
    return per << (log_size - 1)


def layer_bytes(log_size: int, line: bool, circle: bool) -> int:
    n = 1 << log_size
    b = split_log(log_size)
    table = 2 * (n >> b) + 2 * (1 << (b - 1))
    return 8 * ((line + circle) * (4 * n + table) + 4 * (n >> 1))


def bound_ms(log_size: int, line: bool, circle: bool) -> tuple:
    """(milliseconds, "operations" or "bytes") for one launch."""
    ops = layer_ops(log_size, line, circle) / H100_INT_OPS_PER_S
    mem = layer_bytes(log_size, line, circle) / H100_BYTES_PER_S
    return (ops * 1e3, "operations") if ops >= mem else (mem * 1e3, "bytes")


def last_ops(level: int) -> int:
    """A last layer's int32 operations: level rounds of 2**(level-1)
    butterflies a column (an add, a subtract, a product), then a product by
    2**-level a coefficient."""
    return 4 * (level * (2 * ADD + MUL) * (1 << (level - 1)) + MUL * (1 << level))


def last_bytes(level: int, bound: int) -> int:
    """The layer and the twiddle table read once, the output written once."""
    return 8 * (4 * (1 << level) + (1 << level) - 1 + (4 << bound) + 4)


def last_bound_ms(level: int, bound: int) -> tuple:
    """(milliseconds, "operations" or "bytes") for one launch."""
    ops = last_ops(level) / H100_INT_OPS_PER_S
    mem = last_bytes(level, bound) / H100_BYTES_PER_S
    return (ops * 1e3, "operations") if ops >= mem else (mem * 1e3, "bytes")
