"""ctypes wrapper of the provers' first-layer quotient kernels (csrc/quotients.cu).

  quotients(spec, g, samples, oods, rc, blocks, points, out=None) -> (4, N)
      int64 limbs: the OODS quotient ("FRI answer") of first-layer group g
      at N points of its domain, from its columns' values there; the twin
      of what XLA compiled from recursive_stwo_tpu/prover/device_prove.py
      `_stage_quotients_jit` (:543-568) and prover/stream.py
      `_quot_chunk_jit` (:585-613).

It takes CUDA int64 tensors of canonical residues and raises on anything
else; the plain version is prover/quotients.py `group_answers_plain`.  A
call launches a one-block kernel for what does not depend on the point (the
line coefficients, once a call) and the point kernel, on the current stream
of its tensors' device, without synchronising.  `LAUNCHES` counts calls that
launched.

The group's columns are read in place: `blocks` are tensors whose rows,
taken in order, are the group's columns in group column order (tree-major;
the resident trees' LDE blocks of the group's log size, or a chunk's
evaluated columns), each of unit stride along a row.  The kernel's pointer
table has an entry a tree block of the group (`GroupTables.widths`), each a
run of rows of one of `blocks`.  Its index table is ops/fold_cuda.py's
`spec_tables` restricted to the group: every sampled column in walk order
(its block, its row in the block, its sample and its batch; a column sampled
at two points is two entries) and every sample batch (its first entry, its
length, its shift point).  The points are the domain's (x, y) tables, a pair
of (N,) tensors, or a chunk's tiles (prover/tiles.TilePoints: each tile's
base point and the tile table).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import torch

from . import build
from .composition_cuda import _Ops, _Q, _check_tensor
from .fold_cuda import entry_batches, spec_tables
from .poseidon_cuda import H100_BYTES_PER_S, H100_INT_OPS_PER_S, _raise_on

LAUNCHES = {"quotients": 0}
KERNELS_PER_CALL = 2  # the coefficient kernel and the point kernel

# csrc/quotients.cu's limits and the positions of its `scalars` and `ptrs`
MAX_ENTRIES, MAX_BATCHES, MAX_BLOCKS = 512, 16, 8
DOMAIN_POINTS, TILE_POINTS = 0, 1
S_POINTS, S_ENTRIES, S_BATCHES, S_BLOCKS, S_POINT_MODE, S_TILE_LOG, S_OUT_STRIDE, S_OODS = range(8)
S_RC = S_OODS + 8
S_BLOCK_STRIDE = S_RC + 4
N_SCALARS = S_BLOCK_STRIDE + MAX_BLOCKS
P_OUT, P_TAB, P_SAMPLES, P_SCRATCH, P_X, P_Y, P_TX, P_TY, P_BLOCK = range(9)
N_PTRS = P_BLOCK + MAX_BLOCKS


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class GroupTables(NamedTuple):
    widths: tuple  # columns of each tree block of the group, in tree order
    entries: tuple  # (block, row in the block, sample index, batch) of each sampled column, in walk order
    batches: tuple  # (first entry, entries, shift point x, y) of each sample batch


@lru_cache(maxsize=None)
def group_tables(spec, g: int) -> GroupTables:
    """fold_cuda.spec_tables(spec) restricted to group g, its blocks,
    entries and batches renumbered from 0."""
    t = spec_tables(spec)
    L = spec.all_log_sizes[g]
    blocks = [k for k, (_, log, _) in enumerate(t.blocks) if log == L]
    b0, b1 = t.group_batch[g], t.group_batch[g + 1]
    e0 = t.batches[b0][0]
    e1 = t.batches[b1 - 1][0] + t.batches[b1 - 1][1]
    bts = entry_batches(spec)
    entries = tuple((blocks.index(blk), place, sample, bts[e] - b0)
                    for e, (blk, place, sample) in enumerate(t.columns[e0:e1], start=e0))
    batches = tuple((first - e0, n, cx, cy) for first, n, cx, cy in t.batches[b0:b1])
    return GroupTables(tuple(t.blocks[k][2] for k in blocks), entries, batches)


def check_group(spec, g: int) -> GroupTables:
    t = group_tables(spec, g)
    if not (1 <= len(t.entries) <= MAX_ENTRIES and 1 <= len(t.batches) <= MAX_BATCHES
            and 1 <= len(t.widths) <= MAX_BLOCKS):
        raise ValueError(f"the quotient kernel takes at most {MAX_ENTRIES} sampled columns, {MAX_BATCHES} sample "
                         f"batches and {MAX_BLOCKS} column blocks a group; group {g} has {len(t.entries)}, "
                         f"{len(t.batches)} and {len(t.widths)}")
    return t


@lru_cache(maxsize=None)
def _device_table(spec, g: int, device) -> torch.Tensor:
    t = group_tables(spec, g)
    return torch.tensor(list(t.entries) + list(t.batches), dtype=torch.int32, device=device).reshape(-1)


def block_runs(widths, blocks: list, n_points: int) -> list:
    """(tensor, first row) of each tree block of `widths` within `blocks`,
    whose rows in order are the group's columns; a tree block must lie in
    one tensor."""
    if sum(int(b.shape[0]) for b in blocks) != sum(widths):
        raise ValueError(f"expected {sum(widths)} columns in the blocks, got {[tuple(b.shape) for b in blocks]}")
    runs, k, row = [], 0, 0
    for w in widths:
        while row == blocks[k].shape[0]:
            k, row = k + 1, 0
        if row + w > blocks[k].shape[0]:
            raise ValueError(f"a tree block of {w} columns spans two of the given blocks, {[tuple(b.shape) for b in blocks]}")
        runs.append((blocks[k], row))
        row += w
    for k, blk in enumerate(blocks):
        if blk.dim() != 2 or blk.shape[1] != n_points:
            raise ValueError(f"expected (rows, {n_points}) column blocks, got {tuple(blk.shape)} for block {k}")
        if n_points > 1 and blk.shape[0] and blk.stride(1) != 1:
            raise ValueError(f"expected column block {k}'s entries contiguous along a row")
    return runs


def quotients(spec, g: int, samples: torch.Tensor, oods, rc, blocks: list, points, out=None) -> torch.Tensor:
    """Group g's first-layer quotients at N points on the card: `samples`
    the proof's (S, 4) sampled values, `oods` the OODS point's eight limbs
    (x then y), `rc` the random coefficient's four, `blocks` the group's
    columns' values at the points (see the module docstring), `points`
    a pair of (N,) x and y tensors or a TilePoints.  Writes into `out`, a
    (4, N) int64 tensor of unit stride along a row, or a new one."""
    t = check_group(spec, g)
    dev = samples.device
    _check_tensor(samples, "samples", (spec.total_samples, 4))
    if isinstance(points, tuple) and len(points) == 2:
        mode, tile_log, (x, y), tx, ty = DOMAIN_POINTS, 0, points, None, None
        n_points = x.shape[0]
        _check_tensor(x, "x", (n_points,), dev)
        _check_tensor(y, "y", (n_points,), dev)
    else:
        mode, tile_log, x, y, tx, ty = TILE_POINTS, points.b, points.bx, points.by, points.tx, points.ty
        n_points = x.shape[0] << tile_log
        for name, v, n in (("bx", x, x.shape[0]), ("by", y, x.shape[0]), ("tx", tx, 1 << tile_log),
                           ("ty", ty, 1 << tile_log)):
            _check_tensor(v, name, (n,), dev)
    for k, blk in enumerate(blocks):
        if blk.device != dev or blk.dtype != torch.int64:
            raise ValueError(f"expected int64 column block {k} on {dev}, got {blk.dtype} on {blk.device}")
    runs = block_runs(t.widths, blocks, n_points)
    if out is None:
        out = torch.empty((4, n_points), dtype=torch.int64, device=dev)
    elif (out.device != dev or out.dtype != torch.int64 or tuple(out.shape) != (4, n_points)
          or (n_points > 1 and out.stride(1) != 1)):
        raise ValueError(f"expected a (4, {n_points}) int64 output on {dev} of unit stride along a row")
    scratch = torch.empty(4 * len(t.entries) + 16 * len(t.batches), dtype=torch.int32, device=dev)
    table = _device_table(spec, g, dev)

    scalars = [0] * N_SCALARS
    scalars[S_POINTS], scalars[S_ENTRIES], scalars[S_BATCHES], scalars[S_BLOCKS] = (
        n_points, len(t.entries), len(t.batches), len(t.widths))
    scalars[S_POINT_MODE], scalars[S_TILE_LOG], scalars[S_OUT_STRIDE] = mode, tile_log, out.stride(0)
    scalars[S_OODS:S_OODS + 8] = [int(v) for v in oods]
    scalars[S_RC:S_RC + 4] = [int(v) for v in rc]
    ptrs = [0] * N_PTRS
    for k, (blk, row) in enumerate(runs):
        scalars[S_BLOCK_STRIDE + k] = blk.stride(0)
        ptrs[P_BLOCK + k] = blk.data_ptr() + 8 * row * blk.stride(0)
    ptrs[P_OUT], ptrs[P_TAB], ptrs[P_SAMPLES], ptrs[P_SCRATCH] = (out.data_ptr(), table.data_ptr(),
                                                                  samples.data_ptr(), scratch.data_ptr())
    ptrs[P_X], ptrs[P_Y] = x.data_ptr(), y.data_ptr()
    if tx is not None:
        ptrs[P_TX], ptrs[P_TY] = tx.data_ptr(), ty.data_ptr()
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.quotients_group((ctypes.c_int64 * N_SCALARS)(*scalars), (ctypes.c_int64 * N_PTRS)(*ptrs), stream)
    _raise_on(err, "quotients_group")
    if n_points:
        LAUNCHES["quotients"] += 1
    return out


# ---------------------------------------------------------------------------
# bound: the int32 operations a point needs, counted as ops/fold_cuda counts
# them (a modular add 3, a multiply 6, at 132 SMs x 128 lanes x 1.98 GHz):
# a batch's numerator at its least form, sum of C val - (SA dy + SB), one
# M31 x QM31 product and add a sampled column, then the batch's denominator,
# its inverse and its share; the per-call coefficients are left out (a few
# thousand operations a call).  Against the bytes of every input read once
# (each sampled column's values, the points) and every output written once.
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def point_ops(spec, g: int) -> int:
    """int32 operations of one point of group g."""
    o = _Ops()
    for _, n, _, _ in group_tables(spec, g).batches:
        for _ in range(n):
            o.q_add(_Q, o.q_mul_m31(_Q))
        ta = o.c_mul((o.sub(True, True), True), (True, True))
        tb = o.c_mul((o.sub(True, True), True), (True, True))
        den = o.c_inv((o.sub(ta[0], tb[0]), o.sub(ta[1], tb[1])))
        num = o.q_sub(_Q, o.q_add(o.q_mul_m31(_Q), _Q))
        o.q_add(_Q, o.q_mul_cm31(num, den))
    return o.int_ops


def quotient_bytes(spec, g: int, n_points: int, tile_log=None) -> int:
    """Each input read once (the sampled columns' values, the points as
    (x, y) tables or as tiles' base points and the tile table), each output
    written once."""
    t = group_tables(spec, g)
    columns = len({(blk, row) for blk, row, _, _ in t.entries})
    points = 16 * n_points if tile_log is None else 16 * ((n_points >> tile_log) + (1 << tile_log))
    return n_points * 8 * (columns + 4) + points


def bound_ms(spec, g: int, n_points: int, tile_log=None) -> tuple:
    """(milliseconds, "operations" or "bytes") for one call at n_points."""
    ops = n_points * point_ops(spec, g) / H100_INT_OPS_PER_S
    mem = quotient_bytes(spec, g, n_points, tile_log) / H100_BYTES_PER_S
    return (ops * 1e3, "operations") if ops >= mem else (mem * 1e3, "bytes")
