"""ctypes wrapper of the provers' Poseidon31 Merkle level kernel (csrc/merkle.cu).

  level(children, cols, n) -> (n, 8) int64
      one tree level of n nodes in one launch: the leaf level (children
      None) absorbs its columns 8 a permutation and hashes [0; digest]; a
      node level hashes its child pairs, then [h; digest] if columns of this
      size are merged in.  The twin of what XLA compiled from
      recursive_stwo_tpu/prover/device_prove.py `_absorb_columns` (:49-63)
      and `_commit_levels` (:66-87), and of the Poseidon31 flavour of
      recursive_stwo_tpu/prover/stream.py `_commit_chunk_jit` (:252-333).

It takes CUDA int64 tensors of canonical residues and raises on anything
else; the plain version is prover/commit.py `level_plain`.  The columns are
read in place through their row stride (a streamed tree hands views), the
state stays in registers, and the (n, 8) digests are written once: no (n,
16) state is built in device memory.  A call launches the kernel once on the
current stream of its tensors' device, without synchronising.  `LAUNCHES`
counts the launches.

Limits (ValueError past them, never a truncation): 1 <= n <= MAX_NODES;
children None or (2n, 8) int64, contiguous, 16-byte aligned; cols None (a
node level only) or (n_cols, n) int64 of unit stride along a row; both on
one CUDA device.
"""

from __future__ import annotations

import torch

from . import build
from .poseidon_cuda import BYTES_PER_PERMUTATION, H100_BYTES_PER_S, H100_INT_OPS_PER_S, INT_OPS_PER_PERMUTATION, _raise_on

LAUNCHES = {"merkle_level": 0}
MAX_NODES = 1 << 32  # 2**25 blocks of 128 threads


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def check_level(children, cols, n: int) -> torch.device:
    """The inputs' device; raises ValueError past the kernel's limits."""
    if not 1 <= n <= MAX_NODES:
        raise ValueError(f"the Merkle level kernel takes 1 to {MAX_NODES} nodes, got {n}")
    if children is None and cols is None:
        raise ValueError("a leaf level needs its columns")
    if children is not None:
        if children.dim() != 2 or tuple(children.shape) != (2 * n, 8) or children.dtype != torch.int64:
            raise ValueError(f"expected the children as ({2 * n}, 8) int64, got {tuple(children.shape)} "
                             f"{children.dtype}")
        if not children.is_contiguous() or children.data_ptr() % 16:
            raise ValueError("expected the children contiguous and 16-byte aligned (a pair is read as 16-byte loads)")
    if cols is not None:
        if cols.dim() != 2 or cols.shape[1] != n or cols.dtype != torch.int64:
            raise ValueError(f"expected the columns as (n_cols, {n}) int64, got {tuple(cols.shape)} {cols.dtype}")
        if n > 1 and cols.shape[0] and cols.stride(1) != 1:
            raise ValueError("expected the columns contiguous along a row")
    dev = (children if children is not None else cols).device
    for x in (children, cols):
        if x is not None and (x.device != dev or dev.type != "cuda"):
            raise ValueError(f"expected the children and columns on one CUDA device, got {x.device}")
    return dev


def level(children, cols, n: int) -> torch.Tensor:
    """One tree level's (n, 8) digests on the card (see the module docstring)."""
    dev = check_level(children, cols, n)
    n_cols = 0 if cols is None else int(cols.shape[0])
    out = torch.empty((n, 8), dtype=torch.int64, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.merkle_level(None if children is None else children.data_ptr(),
                               cols.data_ptr() if n_cols else None, n_cols, cols.stride(0) if n_cols else 0,
                               out.data_ptr(), n, stream)
    _raise_on(err, "merkle_level")
    LAUNCHES["merkle_level"] += 1
    return out


# ---------------------------------------------------------------------------
# bound: the permutations' int32 operations (7,476 each, ops/poseidon_cuda)
# against every column word read once, the child pairs read once and the
# digests written once.
# ---------------------------------------------------------------------------


def permutations(n_cols: int, node: bool) -> int:
    """Permutations a node of a level computes."""
    absorb = not node or n_cols > 0
    return int(node) + ((n_cols + 7) // 8 + 1 if absorb else 0)


def level_bytes(n_cols: int, node: bool, n: int) -> int:
    return n * (8 * n_cols + (BYTES_PER_PERMUTATION // 2 if node else 0) + 64)


def bound_ms(n_cols: int, node: bool, n: int) -> tuple:
    """(milliseconds, "operations" or "bytes") for one launch over n nodes."""
    ops = n * permutations(n_cols, node) * INT_OPS_PER_PERMUTATION / H100_INT_OPS_PER_S
    mem = level_bytes(n_cols, node, n) / H100_BYTES_PER_S
    return (ops * 1e3, "operations") if ops >= mem else (mem * 1e3, "bytes")
