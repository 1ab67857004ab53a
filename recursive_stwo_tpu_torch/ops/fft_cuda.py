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
layers is a few launches of one kernel, each a pass over device memory (one
pass up to b = 12, then one more a further 8 layers: three at b = 27), on the
current stream of its tensors' device, without synchronising; the output is
a new tensor and the input is only read.
`LAUNCHES` counts calls that launched: "circle_fft" the whole-column
transforms, "eval_tiles" the tile evaluations.

Whole-column transforms read the per-layer twiddles of circle_fft_host
(`_twiddles`, `_inv_twiddles`) flattened into one int32 table a log size
and direction, lifted to the device once (`_table`; 4 bytes a point).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

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
INTERPOLATE, EVALUATE, TILES = 0, 1, 2
S_MODE, S_COLS, S_LOG_SEGMENT, S_SEGMENTS, S_SOURCES, S_SCALE, S_SOURCE_ROWS = range(7)
S_SOURCE_STRIDE = S_SOURCE_ROWS + MAX_SOURCES
N_SCALARS = S_SOURCE_STRIDE + MAX_SOURCES
P_OUT, P_TABLE, P_BX, P_BY, P_TX, P_TY, P_SOURCE = range(7)
N_PTRS = P_SOURCE + MAX_SOURCES
P = 2**31 - 1


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


def passes(b: int) -> int:
    """The kernel launches of a transform of b layers, as csrc/circle_fft.cu
    plans them: one pass of up to 12, then one more a further 8."""
    return 1 + -(-max(b - 12, 0) // 8)


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
    for k, src in enumerate(sources):
        scalars[S_SOURCE_ROWS + k], scalars[S_SOURCE_STRIDE + k] = src.shape[0], src.stride(0)
        ptrs[P_SOURCE + k] = src.data_ptr() if src.numel() else 0
    ptrs[P_OUT] = out.data_ptr()
    if table is not None:
        ptrs[P_TABLE] = table.data_ptr()
    if tiles is not None:
        ptrs[P_BX], ptrs[P_BY], ptrs[P_TX], ptrs[P_TY] = (t.data_ptr() for t in tiles)
    passes = ctypes.c_int64(0)
    lib = build.load()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.circle_fft((ctypes.c_int64 * N_SCALARS)(*scalars), (ctypes.c_int64 * N_PTRS)(*ptrs), stream,
                             ctypes.byref(passes))
    _raise_on(err, "circle_fft")
    if passes.value:
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
