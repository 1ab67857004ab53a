"""ctypes wrapper of the provers' OODS sampling kernel (csrc/sample.cu).

  sample_columns(jobs) -> ((rows, 4) int64 tensor, [first row of each job])
      every job of a proof in one launch: a job is (coeffs, [factors, ...]),
      a (C, 2**n) int64 block of canonical coefficients on the card and one
      or two points, each given by its (n, 4) QM31 ladder factors
      (prover/prove_host._factors_at_point); the sample of column c at the
      job's point p is output row first + p C + c.  The twin of what XLA
      compiled from recursive_stwo_tpu/prover/device.py `_sample_jit`
      (:244-279) for each block and point of prover/device_prove.py:789-804.

It takes CUDA int64 tensors of canonical residues and raises on anything
else; the plain version is prover/sample.py `sample`, one block and point at
a time.  A call fills the output with zeros and launches the sampling kernel
and a finishing kernel (the sums mod p) on the current stream of the
tensors' device, without synchronising.  `LAUNCHES` counts calls that
launched.

The points go to the kernel as ladders of factors in its argument: factor k
of a point is the same whatever the block's n (the squaring ladder y, x,
2x^2 - 1, ...), so a job of log n reads the first n factors of its ladder,
and jobs at one point share one ladder (`ladders`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build
from .poseidon_cuda import H100_BYTES_PER_S, H100_INT_OPS_PER_S, _raise_on

P = 2**31 - 1
LAUNCHES = {"sample": 0}
KERNELS_PER_CALL = 2  # the sampling kernel and the finishing kernel
# csrc/sample.cu's limits
MAX_LOG, MAX_JOBS, MAX_LADDERS, MAX_POINTS = 27, 12, 6, 2


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _factors(f, n: int) -> np.ndarray:
    f = np.asarray(f, dtype=np.int64).reshape(-1, 4)
    if f.shape[0] != n or (f.size and not ((f >= 0) & (f < P)).all()):
        raise ValueError(f"expected ({n}, 4) canonical ladder factors for a block of 2**{n} coefficients, "
                         f"got {f.shape}")
    return f


def ladders(jobs) -> tuple:
    """(ladders, indices): the distinct points' ladders of factors, a job's
    factors the first n of one ladder (a longer job's factors extend a
    shorter one's ladder), and each job's ladder index per point."""
    out, idx = [], []
    for coeffs, points in jobs:
        n = int(coeffs.shape[1]).bit_length() - 1
        row = []
        for f in points:
            f = _factors(f, n)
            for k, lad in enumerate(out):
                m = min(len(lad), n)
                if np.array_equal(lad[:m], f[:m]):
                    if n > len(lad):
                        out[k] = f
                    row.append(k)
                    break
            else:
                out.append(f)
                row.append(len(out) - 1)
        idx.append(row)
    return out, idx


def check_jobs(jobs) -> torch.device:
    """The device of the jobs' blocks; raises on a job past the kernel's
    limits or a block that is not a CUDA int64 (C >= 1, 2**n) tensor of unit
    stride along a row."""
    if not 1 <= len(jobs) <= MAX_JOBS:
        raise ValueError(f"the sampling kernel takes 1 to {MAX_JOBS} jobs a launch, got {len(jobs)}")
    dev = jobs[0][0].device
    for k, (coeffs, points) in enumerate(jobs):
        if coeffs.dim() != 2 or coeffs.shape[0] < 1:
            raise ValueError(f"expected job {k}'s coefficients as (C >= 1, 2**n), got {tuple(coeffs.shape)}")
        size = int(coeffs.shape[1])
        n = size.bit_length() - 1
        if size != 1 << n or n > MAX_LOG:
            raise ValueError(f"the sampling kernel takes 2**n coefficients a column, n <= {MAX_LOG}; job {k} has "
                             f"{size}")
        if size > 1 and coeffs.stride(1) != 1:
            raise ValueError(f"expected job {k}'s coefficients contiguous along a row")
        if not 1 <= len(points) <= MAX_POINTS:
            raise ValueError(f"the sampling kernel takes 1 to {MAX_POINTS} points a job; job {k} has {len(points)}")
        if coeffs.device != dev or coeffs.device.type != "cuda" or coeffs.dtype != torch.int64:
            raise ValueError(f"expected job {k}'s coefficients int64 on {dev} (a CUDA device), got {coeffs.dtype} on "
                             f"{coeffs.device}")
    return dev


def sample_columns(jobs) -> tuple:
    """Every job's samples in one launch (see the module docstring): a new
    (rows, 4) int64 tensor on the jobs' device, and each job's first row."""
    dev = check_jobs(jobs)
    lads, idx = ladders(jobs)
    if len(lads) > MAX_LADDERS:
        raise ValueError(f"the sampling kernel takes at most {MAX_LADDERS} distinct points a launch, got {len(lads)}")
    words, firsts, rows = [], [], 0
    for (coeffs, points), row in zip(jobs, idx):
        n = int(coeffs.shape[1]).bit_length() - 1
        words += [coeffs.data_ptr(), coeffs.stride(0), coeffs.shape[0], n, len(points)]
        words += row + [0] * (MAX_POINTS - len(row))
        firsts.append(rows)
        rows += coeffs.shape[0] * len(points)
    table = np.zeros((len(lads), MAX_LOG, 4), np.int64)
    for k, lad in enumerate(lads):
        table[k, : len(lad)] = lad
    out = torch.empty((rows, 4), dtype=torch.int64, device=dev)
    flat = table.reshape(-1).tolist()
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.sample_columns((ctypes.c_int64 * len(words))(*words), len(jobs), (ctypes.c_int64 * len(flat))(*flat),
                                 len(lads), out.data_ptr(), rows, stream)
    _raise_on(err, "sample_columns")
    LAUNCHES["sample"] += 1
    return out, firsts


# ---------------------------------------------------------------------------
# bound: the bytes of every coefficient read once and every sample written
# once, against the int32 operations of the sums: four 32 x 32 -> 64-bit
# multiply-adds a coefficient and point (two int32 operations each); the
# tables, folds and block sums are left out (a few percent).
# ---------------------------------------------------------------------------


def job_shapes(jobs) -> list:
    """(columns, log size, points) of each job."""
    return [(int(c.shape[0]), int(c.shape[1]).bit_length() - 1, len(p)) for c, p in jobs]


def sample_bytes(shapes) -> int:
    return sum(cols * (1 << n) * 8 + cols * points * 4 * 8 for cols, n, points in shapes)


def sample_ops(shapes) -> int:
    return sum(cols * (1 << n) * points * 4 * 2 for cols, n, points in shapes)


def bound_ms(shapes) -> tuple:
    """(milliseconds, "operations" or "bytes") for one call on jobs of these
    (columns, log size, points)."""
    ops = sample_ops(shapes) / H100_INT_OPS_PER_S
    mem = sample_bytes(shapes) / H100_BYTES_PER_S
    return (ops * 1e3, "operations") if ops >= mem else (mem * 1e3, "bytes")
