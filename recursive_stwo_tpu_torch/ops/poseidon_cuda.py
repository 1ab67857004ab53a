"""ctypes wrappers of the Poseidon2-16 CUDA kernels (csrc/poseidon2.cu).

  permute_rows       (N, 16) int64 -> (N, 16); twin of the Pallas kernel K1
                     (recursive_stwo_tpu/ops/poseidon_pallas.py::_kernel)
  permute_wordmajor  (L, 16, N) int64 -> (L, 16, N); twin of the Pallas
                     kernel K2 (poseidon_pallas.py::_kernel4)

Both take contiguous CUDA tensors of canonical M31 residues and raise on
anything else; the plain versions live in core/poseidon2.py.  A kernel
launches on the current stream of its tensor's device and does not
synchronise.  `LAUNCHES` counts the launches of each kernel.

K1 has two schedules of one arithmetic (csrc/poseidon2.cu): "quad", four
lanes to a state, and "tile", one thread to a state with the block's rows
staged through shared memory.  `permute_rows` takes the quad schedule below
ROWS_TILE_MIN rows and the tile schedule from there up.
"""

from __future__ import annotations

import torch

from . import build

LAUNCHES = {"permute_rows": 0, "permute_wordmajor": 0}
ROWS_SCHEDULES = ("quad", "tile")
# the crossover, measured with tools/kernel_times.py on an H100 SXM (700 W):
# quad 21.5 / tile 26.7 us at 2**15 rows, quad 37.9 / tile 36.6 us at 2**16
ROWS_TILE_MIN = 1 << 16

# The least time an H100 SXM could take for n permutations, either kernel:
# the int32 operations of one permutation (csrc/poseidon2.cuh: 1,360 modular
# adds at 3 operations, 426 widening multiplies with their two 2**31 folds
# at 10, 210 rotations at 4) at 132 SMs x 128 lanes x 1.98 GHz, against
# 16 int64 words read and 16 written at 3.35 TB/s.
INT_OPS_PER_PERMUTATION = 1360 * 3 + 426 * 10 + 210 * 4
H100_INT_OPS_PER_S = 132 * 128 * 1.98e9
H100_BYTES_PER_S = 3.35e12
BYTES_PER_PERMUTATION = 2 * 16 * 8


def bound_ms(n_states: int) -> tuple:
    """(milliseconds, "operations" or "bytes"): the larger of the two floors
    for n_states permutations, and which one it is."""
    ops = n_states * INT_OPS_PER_PERMUTATION / H100_INT_OPS_PER_S
    mem = n_states * BYTES_PER_PERMUTATION / H100_BYTES_PER_S
    return (ops * 1e3, "operations") if ops >= mem else (mem * 1e3, "bytes")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(x: torch.Tensor, ndim: int, words_dim: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got one on {x.device}")
    if x.dtype != torch.int64:
        raise TypeError(f"expected torch.int64, got {x.dtype}")
    if x.dim() != ndim or x.shape[words_dim] != 16:
        raise ValueError(f"expected 16 words on dim {words_dim} of a {ndim}-D tensor, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("expected a contiguous tensor")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def permute_rows(x: torch.Tensor) -> torch.Tensor:
    """Poseidon2 permutation of each row of an (N, 16) CUDA tensor, whose
    data must be 16-byte aligned (any tensor that owns its storage is)."""
    return permute_rows_schedule(x, "quad" if x.shape[0] < ROWS_TILE_MIN else "tile")


def permute_rows_schedule(x: torch.Tensor, schedule: str) -> torch.Tensor:
    """permute_rows on the named schedule (the tests and the timing tools
    hold each schedule to the plain version and time it)."""
    if schedule not in ROWS_SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}, expected one of {ROWS_SCHEDULES}")
    _check(x, 2, 1)
    if x.data_ptr() % 16:
        raise ValueError("permute_rows reads 16-byte vectors: the data must be 16-byte aligned")
    out = torch.empty_like(x)
    fn = getattr(build.load(), f"p2_permute_rows_{schedule}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), x.shape[0], stream)
    _raise_on(err, "permute_rows")
    if x.shape[0]:
        LAUNCHES["permute_rows"] += 1
    return out


def permute_wordmajor(x: torch.Tensor) -> torch.Tensor:
    """Poseidon2 permutation of the (L, N) states of an (L, 16, N) CUDA tensor."""
    _check(x, 3, 1)
    out = torch.empty_like(x)
    lib = build.load()
    n_lanes, _, n = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.p2_permute_wordmajor(x.data_ptr(), out.data_ptr(), n_lanes, n, stream)
    _raise_on(err, "permute_wordmajor")
    if n_lanes * n:
        LAUNCHES["permute_wordmajor"] += 1
    return out
