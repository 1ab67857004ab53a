"""ctypes wrapper of the circle FFT kernels (csrc/circle_fft.cu).

  interpolate(values) -> coefficients: evaluations (..., 2**n) in
      bit-reversed circle-domain order to the stwo basis, the twin of
      recursive_stwo_tpu/prover/circle_fft.py `interpolate_traced` (:156);
  evaluate(coeffs, log_size) -> evaluations (..., 2**log_size): the
      coefficients (..., 2**b), b <= log_size, zero-padded and evaluated,
      `evaluate_traced` (:174) of `extend_traced` (:193), as device_prove.py
      `_lde_t` (:149) takes them; the padding is never written;
  eval_tiles(blocks, tiles) -> (rows, G * 2**b): base coefficients evaluated
      on G tiles of a larger domain, prover/stream.py `_eval_tiles` (:176)
      with the twiddles `_tile_twiddles` (:164) derives from the tiles'
      points, which the kernel derives in turn from each tile's base point
      and the tile table (prover/tiles.TilePoints).

Each takes CUDA int64 tensors of canonical residues and raises on anything
else; the plain versions are prover/circle_fft.py `interpolate_plain` /
`evaluate_plain` and prover/stream.py `_eval_tiles`.  A transform of b
layers is one pass over device memory up to b = 18 (a block's tile of up to
2**14 words, a cluster of up to 16 blocks) and two above (`plan`,
`passes`); a tile evaluation launches a twiddle kernel first.  Each runs on
the current stream of its tensors' device, without synchronising; the
output is a new tensor and the input is only read.
`LAUNCHES` counts calls that launched: "circle_fft" the whole-column
transforms, "eval_tiles" the tile evaluations.

Whole-column transforms read the per-layer twiddles of circle_fft_host
(`_twiddles`, `_inv_twiddles`) flattened into one int32 table a log size
and direction, lifted to the device once (`_table`; 4 bytes a point); a
tile evaluation derives its tiles' table into scratch of the same layout.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..prover import circle_fft_host as host_fft
from . import build
from .composition_cuda import MUL, _Ops
from .poseidon_cuda import H100_BYTES_PER_S, H100_INT_OPS_PER_S, _raise_on

LAUNCHES = {"circle_fft": 0, "eval_tiles": 0}

# csrc/circle_fft.cu's limits and the positions of its `scalars` and `ptrs`
MAX_LOG = 27  # positions a column
MAX_SOURCES = 8  # source blocks of one tile evaluation
MAX_PASSES = 2
INTERPOLATE, EVALUATE, TILES = 0, 1, 2
S_MODE, S_COLS, S_LOG_SEGMENT, S_SEGMENTS, S_SOURCES, S_SCALE, S_PASSES, S_PLAN = range(8)
PASS_FIELDS = 6  # a pass's (k0, S, c, U, R, Bt)
S_SOURCE_ROWS = S_PLAN + PASS_FIELDS * MAX_PASSES
S_SOURCE_STRIDE = S_SOURCE_ROWS + MAX_SOURCES
N_SCALARS = S_SOURCE_STRIDE + MAX_SOURCES
P_OUT, P_TABLE, P_BX, P_BY, P_TX, P_TY, P_SOURCE = range(7)
N_PTRS = P_SOURCE + MAX_SOURCES
P = 2**31 - 1
WORDS_PER_THREAD = 64  # a thread holds 64 words of its block's tile


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@lru_cache(maxsize=None)
def _table(log_size: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """circle_fft_host's per-layer twiddles of the 2**log_size domain,
    layer k at 2**log_size - 2**(log_size - k), int32 on `device`."""
    layers = host_fft._inv_twiddles(log_size) if inverse else host_fft._twiddles(log_size)
    flat = np.concatenate(layers) if layers else np.zeros(0, np.uint32)
    return torch.from_numpy(flat.astype(np.int32)).to(device)


# ---------------------------------------------------------------------------
# the pass plan: which layers each launch runs and how its tiles are cut.
# A pass runs layers [k0, k0 + S) on tiles of 2**(U + S + c) elements e =
# (u << (S + c)) | (m << c) | l (2**U units of 2**S positions, runs of 2**c
# contiguous positions), each held by a cluster of 2**R blocks of 2**Bt words
# (U + S + c = Bt + R).  The kernel checks every pass it is given.
# ---------------------------------------------------------------------------


class Limits(NamedTuple):
    block_min: int = 13  # a block's tile where a pass's layers fit in it: 2**13 words, 128 threads
    block_max: int = 14  # at most 2**14 words (72 KB of dynamic shared memory, 256 threads); fft_pass_kernel
    # is held to three blocks an SM (csrc/circle_fft.cu, __launch_bounds__)
    cluster_pref: int = 3  # clusters of up to 8 blocks (the portable size) while a block's tile can grow
    cluster_max: int = 4  # then up to 16
    split: int = 17  # past one pass's reach: the contiguous pass's layers
    min_run: int = 4  # a strided tile's contiguous run: at least 16 positions, 128 bytes of int64


HOPPER = Limits()


class Pass(NamedTuple):
    k0: int
    S: int
    c: int
    U: int
    R: int
    Bt: int


def _trailing_zeros(n: int) -> int:
    return (n & -n).bit_length() - 1


def _contiguous(L: int, units: int, lim: Limits) -> Pass:
    """Layers [0, L) of `units` consecutive runs of 2**L positions: a block
    of 2**block_min words (several runs a block where they fit, as many as
    divide `units`), or a cluster: up to 2**cluster_pref blocks of
    2**block_min words, larger blocks up to 2**block_max, then up to
    2**cluster_max blocks."""
    if L <= lim.block_min:
        U = min(lim.block_min - L, _trailing_zeros(units))
        return Pass(0, L, 0, U, 0, L + U)
    R = min(lim.cluster_pref, L - lim.block_min)
    if L - R > lim.block_max:
        R = L - lim.block_max
    if not R <= min(L - R, lim.cluster_max):
        raise ValueError(f"{L} layers exceed a cluster's 2**{lim.block_max + lim.cluster_max} words")
    return Pass(0, L, 0, 0, R, L - R)


def plan(b: int, segments: int, inverse: bool, lim: Limits = HOPPER) -> tuple:
    """The passes of a transform of b layers over `segments` segments of
    2**b, in the order they run: one contiguous pass up to the reach of a
    cluster (block_max + cluster_max layers); past it a contiguous pass of
    layers [0, split) and a strided one of the rest, the interpolation's
    contiguous pass first, the evaluation's last."""
    if b <= lim.block_max + lim.cluster_max:
        return (_contiguous(b, segments, lim),)
    S = b - lim.split
    Bt = max(lim.block_min, S + lim.min_run)
    if Bt > lim.block_max:
        raise ValueError(f"{S} strided layers exceed a block's 2**{lim.block_max} words")
    strided = Pass(lim.split, S, Bt - S, 0, 0, Bt)
    contiguous = _contiguous(lim.split, segments << S, lim)
    return (contiguous, strided) if inverse else (strided, contiguous)


def passes(b: int) -> int:
    """The pass kernel's launches for a transform of b layers, as `plan`
    cuts it: one up to 18 layers (a cluster of 16 blocks of 2**14 words),
    two above."""
    return len(plan(b, 1, False))


def kernels_per_call(b: int, tiles: bool = False) -> int:
    """Kernels a call launches: its passes, and a tile evaluation's twiddle
    kernel (b >= 1)."""
    return passes(b) + (1 if tiles and b else 0)


def threads(p: Pass) -> int:
    """A pass's block: 64 words of the tile a thread, at least a warp."""
    return max(32, (1 << p.Bt) // WORDS_PER_THREAD)


def smem_bytes(p: Pass) -> int:
    """A pass's dynamic shared memory: its tile and one pad word a 32."""
    return 4 * ((1 << p.Bt) + ((1 << p.Bt) >> 3))


def _log(n: int, what: str) -> int:
    log = n.bit_length() - 1
    if n < 1 or 1 << log != n:
        raise ValueError(f"{what}: length {n} is not a power of two")
    if log > MAX_LOG:
        raise ValueError(f"{what}: 2**{log} points exceed the kernel's 2**{MAX_LOG}")
    return log


def _check(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor for {name}, got one on {x.device}")
    if x.dtype != torch.int64:
        raise TypeError(f"expected torch.int64 for {name}, got {x.dtype}")


def _rows(x: torch.Tensor, name: str) -> torch.Tensor:
    """x (..., n) as (rows, n) with unit stride along a row (a view when the
    leading dimensions allow one)."""
    _check(x, name)
    if x.dim() == 0:
        raise ValueError(f"expected at least one dimension for {name}")
    rows = x.reshape(-1, x.shape[-1])
    if rows.shape[1] > 1 and rows.stride(1) != 1:
        rows = rows.contiguous()
    return rows


def _launch(mode: int, out: torch.Tensor, sources: list, b: int, segments: int, table=None, tiles=None,
            scale: int = 0) -> None:
    scalars = [0] * N_SCALARS
    ptrs = [0] * N_PTRS
    scalars[S_MODE], scalars[S_COLS], scalars[S_LOG_SEGMENT], scalars[S_SEGMENTS] = mode, out.shape[0], b, segments
    scalars[S_SOURCES], scalars[S_SCALE] = len(sources), scale
    steps = plan(b, segments, mode == INTERPOLATE)
    scalars[S_PASSES] = len(steps)
    for i, step in enumerate(steps):
        scalars[S_PLAN + PASS_FIELDS * i : S_PLAN + PASS_FIELDS * (i + 1)] = step
    for k, src in enumerate(sources):
        scalars[S_SOURCE_ROWS + k], scalars[S_SOURCE_STRIDE + k] = src.shape[0], src.stride(0)
        ptrs[P_SOURCE + k] = src.data_ptr() if src.numel() else 0
    ptrs[P_OUT] = out.data_ptr()
    if table is not None:
        ptrs[P_TABLE] = table.data_ptr()
    if tiles is not None:
        # the tiles' twiddles, derived by the kernel (layer k at N - (N >> k))
        table = torch.empty(max((segments << b) - segments, 1), dtype=torch.int32, device=out.device)
        ptrs[P_TABLE] = table.data_ptr()
        ptrs[P_BX], ptrs[P_BY], ptrs[P_TX], ptrs[P_TY] = (t.data_ptr() for t in tiles)
    launched = ctypes.c_int64(0)
    lib = build.load()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.circle_fft((ctypes.c_int64 * N_SCALARS)(*scalars), (ctypes.c_int64 * N_PTRS)(*ptrs), stream,
                             ctypes.byref(launched))
    _raise_on(err, "circle_fft")
    if launched.value:
        LAUNCHES["eval_tiles" if mode == TILES else "circle_fft"] += 1


def interpolate(values: torch.Tensor) -> torch.Tensor:
    """Evaluations (..., 2**n) in bit-reversed domain order -> coefficients."""
    rows = _rows(values, "values")
    log = _log(rows.shape[1], "interpolate")
    out = torch.empty(rows.shape, dtype=torch.int64, device=values.device)
    _launch(INTERPOLATE, out, [rows], log, 1, table=_table(log, True, values.device),
            scale=pow(1 << log, P - 2, P))
    return out.reshape(values.shape)


def evaluate(coeffs: torch.Tensor, log_size: int) -> torch.Tensor:
    """Coefficients (..., 2**b) -> evaluations (..., 2**log_size) in
    bit-reversed domain order, the coefficients zero-padded to 2**log_size."""
    rows = _rows(coeffs, "coeffs")
    b = _log(rows.shape[1], "evaluate")
    if not b <= log_size <= MAX_LOG:
        raise ValueError(f"cannot evaluate 2**{b} coefficients on a domain of 2**{log_size} (at most 2**{MAX_LOG})")
    out = torch.empty((rows.shape[0], 1 << log_size), dtype=torch.int64, device=coeffs.device)
    _launch(EVALUATE, out, [rows], b, 1 << (log_size - b), table=_table(log_size, False, coeffs.device))
    return out.reshape(coeffs.shape[:-1] + (1 << log_size,))


def eval_tiles(blocks: list, bx: torch.Tensor, by: torch.Tensor, tx: torch.Tensor, ty: torch.Tensor) -> torch.Tensor:
    """Base coefficient blocks (n_i, 2**b), each of unit stride along a row,
    evaluated on the G tiles whose base points are (bx, by) (G,) with the
    tile table (tx, ty) (2**b,) -> (sum of n_i, G * 2**b), the blocks' rows
    in order."""
    if not 1 <= len(blocks) <= MAX_SOURCES:
        raise ValueError(f"expected 1 to {MAX_SOURCES} coefficient blocks, got {len(blocks)}")
    dev = blocks[0].device
    width = blocks[0].shape[-1] if blocks[0].dim() == 2 else -1
    for k, blk in enumerate(blocks):
        _check(blk, f"coefficient block {k}")
        if blk.device != dev:
            raise ValueError(f"coefficient block {k} on {blk.device}, block 0 on {dev}")
        if blk.dim() != 2 or blk.shape[1] != width:
            raise ValueError(f"expected (rows, {width}) coefficient blocks, got {tuple(blk.shape)} for block {k}")
        if width > 1 and blk.shape[0] and blk.stride(1) != 1:
            raise ValueError(f"expected coefficient block {k}'s entries contiguous along a row")
    b = _log(width, "eval_tiles")
    G = bx.shape[0] if bx.dim() == 1 else -1
    for name, x, n in (("bx", bx, G), ("by", by, G), ("tx", tx, 1 << b), ("ty", ty, 1 << b)):
        _check(x, name)
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, the coefficients on {dev}")
        if x.dim() != 1 or x.shape[0] != n or not x.is_contiguous():
            raise ValueError(f"expected a contiguous ({n},) tensor for {name}, got {tuple(x.shape)}")
    if G < 1 or G << b > 1 << MAX_LOG:
        raise ValueError(f"{G} tiles of 2**{b} points: expected 1 to 2**{MAX_LOG} points")
    out = torch.empty((sum(blk.shape[0] for blk in blocks), G << b), dtype=torch.int64, device=dev)
    _launch(TILES, out, blocks, b, G, tiles=(bx, by, tx, ty))
    return out


# ---------------------------------------------------------------------------
# bounds: the int32 operations of a transform (a butterfly is a modular
# product and two sums; the interpolation's scale one product a point; a
# tile's twiddles its point coordinates and doublings, as _tile_twiddles
# derives them), counted as ops/composition_cuda counts them (a modular add
# 3, a multiply 6, at 132 SMs x 128 lanes x 1.98 GHz), against the bytes of
# every input read once (the int64 sources, the int32 twiddles the layers
# use, the tiles' int64 points) and every output written once.
# ---------------------------------------------------------------------------


def _butterfly_ops() -> int:
    o = _Ops()
    o.add(True, o.mul(True, True))
    o.sub(True, True)
    return o.int_ops


def transform_ops(rows: int, b: int, segments: int, interpolate: bool = False, tiles: bool = False) -> int:
    """int32 operations of a transform of `rows` columns, each `segments`
    segments of 2**b, b layers each."""
    n = segments << b
    ops = rows * (n // 2) * b * _butterfly_ops()
    if interpolate:
        ops += rows * n * MUL  # the scale by 1/2**b
    if tiles and b:
        o = _Ops()
        o.add(o.mul(True, True), o.mul(True, True))  # a layer-0 twiddle: y of a point
        ops += segments * (1 << (b - 1)) * o.int_ops
        if b > 1:
            o = _Ops()
            o.sub(o.mul(True, True), o.mul(True, True))  # a layer-1 twiddle: x of a point
            ops += segments * (1 << (b - 2)) * o.int_ops
            o = _Ops()
            sq = o.mul(True, True)
            o.sub(o.add(sq, sq), True)  # a doubling
            ops += segments * sum(1 << (b - 1 - k) for k in range(2, b)) * o.int_ops
    return ops


def transform_bytes(rows: int, b: int, segments: int, source_len: int, tiles: bool = False) -> int:
    """Each input read once, each output written once."""
    n = segments << b
    twiddles = 16 * (segments + (1 << b)) if tiles else 4 * sum(n >> (k + 1) for k in range(b))
    return rows * (source_len + n) * 8 + twiddles


def bound_ms(rows: int, b: int, segments: int, source_len: int, interpolate: bool = False,
             tiles: bool = False) -> tuple:
    """(milliseconds, "operations" or "bytes") for one transform."""
    ops = transform_ops(rows, b, segments, interpolate, tiles) / H100_INT_OPS_PER_S
    mem = transform_bytes(rows, b, segments, source_len, tiles) / H100_BYTES_PER_S
    return (ops * 1e3, "operations") if ops >= mem else (mem * 1e3, "bytes")
