"""ctypes wrapper of the fold kernel (csrc/fold.cu).

  fold(spec, pa, raw_queries, oods, random_coeff, fri_alphas)
      -> (answers (G, B, Q, 4), self_vals (n_inner, B, Q, 4), (B,) bool):
      the verifier's fold phase of a batch in one launch, a block a proof:
      every group's OODS quotient, the first layer's circle folds, the inner
      layers' line folds and the last-layer check; the twin of what XLA
      compiled from recursive_stwo_tpu/verifier/verify.py `fold_phase`
      (:97-126).

It takes CUDA int64 tensors of canonical residues and raises on anything
else; the plain version is verifier/verify.fold_values_plain.  The kernel
launches on the current stream of its tensors' device and does not
synchronise.  `LAUNCHES` counts its launches; the host work before the
launch is one `fold.prepare` span (utils/spans.py).

The kernel reads the tree column blocks in place.  Its index table, built
here on the host and cached per spec (`spec_tables`), has an entry for
every sample of every group's columns, in the order the eager
`fri_answers_for_group` walks them (group by group, sample batch by sample
batch of `quotients_host.group_batches`; a column sampled at two points is
in two batches): the column's block (one of `blocks`: a tree's (B, Q,
width) columns at the group's log size), its place in the block, the
sample's index and its batch; and for every sample batch its first entry,
its length and its shift point (the identity for the OODS batch).  A block
computes each entry's line coefficients once a proof, thread t the entries
t, t + 128, ...; W lanes a query (`lanes_per_query`) split each batch's
entries for a slot's sums, lane w the entries first + w, first + w + W, ...
of each batch, reading the proof's tree column rows, which the block stages
in shared memory.  Its shared memory is laid out here (`smem_layout`); a
spec and query count whose layout exceeds a block's shared memory raises.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..core import circle_host as circle
from ..core.circle_host import Coset
from ..verifier.points_host import _J
from ..utils.spans import span
from ..verifier.quotients_host import group_batches
from . import build
from .composition_cuda import _check_tensor, _Ops, _Q, _Z
from .poseidon_cuda import H100_BYTES_PER_S, H100_INT_OPS_PER_S, _raise_on

LAUNCHES = {"fold_phase": 0}

# csrc/fold.cu's limits and the positions of its `scalars` and `ptrs` arrays
MAX_LOG, MAX_GROUPS, MAX_BLOCKS, MAX_INNER, MAX_LAST_LOG = 31, 8, 32, 32, 16
THREADS = 128  # a block, one proof
SMEM_MAX = 232448  # an H100 block's shared memory, bytes
MAX_STAGED_LOG = 10  # last layers of up to 2**10 coefficients are staged in shared memory
(S_BATCH, S_QUERIES, S_SAMPLES, S_PARAMS, S_FIRST_LOG, S_INNER, S_GROUPS, S_LAST_LOG, S_ENTRIES, S_INIT_X,
 S_INIT_Y, S_JX, S_JY, S_LANES, S_CHUNK, S_ALPHA_ROWS, S_STEP) = range(17)
S_GROUP_LOG = S_STEP + 2 * MAX_LOG
S_GROUP_BATCH = S_GROUP_LOG + MAX_GROUPS
S_BLOCK_WIDTH = S_GROUP_BATCH + MAX_GROUPS + 1
S_LAYOUT = S_BLOCK_WIDTH + MAX_BLOCKS
N_SCALARS = S_LAYOUT + 20
# csrc/fold.cu's shared-memory regions (its enum Region, in order): QM31
# regions first (four words an element, 16-byte aligned), then words; the
# last two (A and B, read only before step 1) overlay the chunk's scratch
# SCRATCH, which step 1 writes first
SMEM_REGIONS = ("alpha", "c", "pxy", "sums", "fri", "coef", "sib", "ans", "folded", "inv", "dy", "den", "dbl", "cols",
                "col_at", "a", "b")
SCRATCH = ("ans", "folded", "inv", "dy", "den", "dbl")
P_RAW, P_SAMPLES, P_PARAMS, P_LAST_POLY, P_TAB, P_ANSWERS, P_SELF_VALS, P_LAST_EQ, P_BLOCKS = range(9)
P_FIRST_SIB = P_BLOCKS + MAX_BLOCKS
P_INNER_SIB = P_FIRST_SIB + MAX_GROUPS
N_PTRS = P_INNER_SIB + MAX_INNER
IDENTITY = (1, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class FoldTables(NamedTuple):
    blocks: tuple  # (tree, log size, width) of each column block, group by group
    columns: tuple  # (block, place in the block, sample index) of each sampled column, in walk order
    batches: tuple  # (first entry of columns, entries, shift point x, y) of each sample batch
    group_batch: tuple  # group g's batches are group_batch[g]:group_batch[g + 1]
    steps: tuple  # point(2**(30 - k)) for k = 0..M-1 (k = 0 unused)


def _shift_point(key) -> tuple:
    shift, tlog = key
    if shift == 0:
        return IDENTITY
    return circle.point_at_index((shift * circle.subgroup_gen_index(tlog)) % (1 << 31))


@lru_cache(maxsize=None)
def spec_tables(spec) -> FoldTables:
    """The kernel's index tables of `spec` (see the module docstring)."""
    M = spec.max_first_layer_log
    blocks, columns, batches, group_batch = [], [], [], [0]
    for g, L in enumerate(spec.all_log_sizes):
        # a tree's columns of log size L, in tree order, are one block
        block_of = {}
        for t in range(4):
            width = spec.n_columns_per_log_size[t].get(L, 0)
            if width:
                block_of[t] = len(blocks)
                blocks.append((t, L, width))
        place = {}
        for t, col in spec.group_columns[g]:
            place[(t, col)] = sum(1 for t2, c2 in place if t2 == t)
        for key, cols in group_batches(spec, g):
            batches.append((len(columns), len(cols)) + tuple(_shift_point(key)))
            for local, sample in cols:
                t, col = spec.group_columns[g][local]
                columns.append((block_of[t], place[(t, col)], sample))
        group_batch.append(len(batches))
    steps = ((0, 0),) + tuple(circle.point_at_index(1 << (30 - k)) for k in range(1, M))
    return FoldTables(tuple(blocks), tuple(columns), tuple(batches), tuple(group_batch), steps)


def entry_batches(spec) -> tuple:
    """The sample batch of each entry of spec_tables(spec).columns."""
    t = spec_tables(spec)
    return tuple(bt for bt, (_, n, _, _) in enumerate(t.batches) for _ in range(n))


@lru_cache(maxsize=None)
def _device_table(spec, device) -> torch.Tensor:
    t = spec_tables(spec)
    rows = [c + (bt,) for c, bt in zip(t.columns, entry_batches(spec))] + list(t.batches)
    return torch.tensor(rows, dtype=torch.int32, device=device).reshape(-1)


def lanes_per_query(n_queries: int) -> int:
    """W, the lanes of a query in the kernel's quotient and last-layer
    steps: the largest power of two up to 32 with W * Q <= THREADS (1 for
    more than THREADS / 2 queries)."""
    w = 32
    while w > 1 and w * n_queries > THREADS:
        w //= 2
    return w


def chunk_queries(n_queries: int) -> int:
    """Queries a chunk: a block takes a proof's queries in chunks of W * chunk
    <= THREADS lanes (all of them when Q <= THREADS)."""
    return min(n_queries, THREADS // lanes_per_query(n_queries))


def alpha_rows(spec) -> int:
    """Rows of the kernel's alpha_k = -2u rc^k table: the largest group's
    entries (k restarts at 0 each group)."""
    t = spec_tables(spec)
    return max(t.batches[t.group_batch[g + 1] - 1][0] + t.batches[t.group_batch[g + 1] - 1][1]
               - t.batches[t.group_batch[g]][0] for g in range(len(t.group_batch) - 1))


class SmemLayout(NamedTuple):
    offsets: tuple  # each region's first word (SMEM_REGIONS), and the end of the last
    sizes: tuple  # each region's words
    bytes: int


@lru_cache(maxsize=None)
def smem_layout(spec, n_queries: int) -> SmemLayout:
    """The kernel's shared memory for this spec at Q queries: each region's
    size in words (a QM31 four), laid out in SMEM_REGIONS order."""
    t = spec_tables(spec)
    E, NB, G, n_inner = len(t.columns), len(t.batches), len(spec.all_log_sizes), spec.n_inner_layers
    d = spec.log_last_layer_degree_bound
    qc = chunk_queries(n_queries)
    sizes = dict(
        alpha=4 * alpha_rows(spec), c=4 * E, a=4 * E, b=4 * E, pxy=8 * NB, sums=8 * NB, fri=4 * (n_inner + 1),
        coef=4 << d if d <= MAX_STAGED_LOG else 0, sib=4 * (G + n_inner) * qc, ans=4 * G * qc, folded=4 * qc,
        cols=qc * sum(width for _, _, width in t.blocks), col_at=2 * E, inv=(n_inner + G + NB) * qc, dy=G * qc,
        den=2 * NB * qc, dbl=d * qc,
    )
    offsets, at = {}, 0
    for name in SMEM_REGIONS[:-2]:
        offsets[name] = at
        at += sizes[name]
        if name == SCRATCH[-1]:  # A and B over the scratch
            offsets["a"] = offsets[SCRATCH[0]]
            offsets["b"] = offsets["a"] + sizes["a"]
            at = max(at, offsets["b"] + sizes["b"])
    return SmemLayout(tuple(offsets[name] for name in SMEM_REGIONS) + (at,),
                      tuple(sizes[name] for name in SMEM_REGIONS), 4 * at)


def _check_shape(spec) -> None:
    M, n_inner = spec.max_first_layer_log, spec.n_inner_layers
    logs = spec.all_log_sizes
    t = spec_tables(spec)
    if not (1 <= M < MAX_LOG and 0 <= n_inner <= MAX_INNER and n_inner < M and len(logs) <= MAX_GROUPS
            and len(t.blocks) <= MAX_BLOCKS and 0 <= spec.log_last_layer_degree_bound <= MAX_LAST_LOG):
        raise ValueError(f"the fold kernel takes no spec of log sizes {logs}, {n_inner} inner layers and a last "
                         f"layer of 2**{spec.log_last_layer_degree_bound}")
    if min(logs) < M - n_inner:
        raise ValueError(f"log size {min(logs)} lies below the last fold ({M - n_inner})")


def _check_smem(spec, n_queries: int) -> None:
    need = smem_layout(spec, n_queries).bytes
    if need > SMEM_MAX:
        raise ValueError(f"the fold kernel's shared memory for this spec at {n_queries} queries, {need} bytes, "
                         f"exceeds a block's {SMEM_MAX}")


def _scalars(spec, batch: int, n_queries: int, n_params: int) -> list:
    t = spec_tables(spec)
    M = spec.max_first_layer_log
    s = [0] * N_SCALARS
    init = Coset.half_odds(M).initial
    s[S_BATCH], s[S_QUERIES], s[S_SAMPLES], s[S_PARAMS] = batch, n_queries, spec.total_samples, n_params
    s[S_FIRST_LOG], s[S_INNER], s[S_GROUPS] = M, spec.n_inner_layers, len(spec.all_log_sizes)
    s[S_LAST_LOG], s[S_ENTRIES] = spec.log_last_layer_degree_bound, len(t.columns)
    s[S_LANES], s[S_CHUNK], s[S_ALPHA_ROWS] = lanes_per_query(n_queries), chunk_queries(n_queries), alpha_rows(spec)
    layout = smem_layout(spec, n_queries)
    s[S_LAYOUT:S_LAYOUT + len(SMEM_REGIONS)] = layout.offsets[:-1]
    s[S_LAYOUT + len(SMEM_REGIONS)] = layout.bytes
    s[S_INIT_X], s[S_INIT_Y], s[S_JX], s[S_JY] = int(init[0]), int(init[1]), int(_J[0]), int(_J[1])
    for k, (x, y) in enumerate(t.steps):
        s[S_STEP + 2 * k], s[S_STEP + 2 * k + 1] = int(x), int(y)
    for g, L in enumerate(spec.all_log_sizes):
        s[S_GROUP_LOG + g] = L
    for g, first in enumerate(t.group_batch):
        s[S_GROUP_BATCH + g] = first
    for k, (_, _, width) in enumerate(t.blocks):
        s[S_BLOCK_WIDTH + k] = width
    return s


def fold(spec, pa, raw_queries: torch.Tensor, oods, random_coeff, fri_alphas) -> tuple:
    """The fold phase of a batch on the card: `pa` the batch's ProofArrays
    (samples, tree columns, FRI siblings, last-layer polynomials),
    raw_queries (B, Q), the OODS point (x, y), the quotients' random
    coefficient and the n_inner + 1 FRI alphas, every QM31 a tuple of four
    (B,) limbs.  Returns the (G, B, Q, 4) answers, the (n_inner, B, Q, 4)
    self values and the (B,) last-layer check."""
    with span("fold.prepare"):  # the host work before the launch
        _check_shape(spec)
        t = spec_tables(spec)
        M, n_inner = spec.max_first_layer_log, spec.n_inner_layers
        n_groups = len(spec.all_log_sizes)
        batch, n_queries = raw_queries.shape
        _check_smem(spec, n_queries)
        dev = raw_queries.device
        _check_tensor(raw_queries, "raw_queries", (batch, n_queries))
        _check_tensor(pa.samples_flat, "samples_flat", (batch, spec.total_samples, 4), dev)
        _check_tensor(pa.last_poly, "last_poly", (batch, 1 << spec.log_last_layer_degree_bound, 4), dev)
        if len(fri_alphas) != n_inner + 1:
            raise ValueError(f"expected {n_inner + 1} FRI alphas, got {len(fri_alphas)}")
        qms = (*oods, random_coeff, *fri_alphas)
        params = torch.stack([torch.as_tensor(c, device=dev).expand(batch) for v in qms for c in v], dim=-1)
        _check_tensor(params, "the QM31 parameters", (batch, 4 * len(qms)), dev)

        ptrs = [0] * N_PTRS
        for k, (tree, L, width) in enumerate(t.blocks):
            x = pa.tree_paths[tree].columns[L]
            _check_tensor(x, f"tree {tree}'s columns at log size {L}", (batch, n_queries, width), dev)
            ptrs[P_BLOCKS + k] = x.data_ptr()
        for g, L in enumerate(spec.all_log_sizes):
            x = pa.first_layer_paths.sibling_columns[L]
            _check_tensor(x, f"the first layer's siblings at log size {L}", (batch, n_queries, 4), dev)
            ptrs[P_FIRST_SIB + g] = x.data_ptr()
        for i in range(n_inner):
            x = pa.inner_layer_paths[i].sibling_columns[M - 1 - i]
            _check_tensor(x, f"inner layer {i}'s siblings", (batch, n_queries, 4), dev)
            ptrs[P_INNER_SIB + i] = x.data_ptr()

        answers = torch.empty((n_groups, batch, n_queries, 4), dtype=torch.int64, device=dev)
        self_vals = torch.empty((n_inner, batch, n_queries, 4), dtype=torch.int64, device=dev)
        last_eq = torch.empty((batch, n_queries), dtype=torch.bool, device=dev)
        table = _device_table(spec, dev)
        ptrs[P_RAW], ptrs[P_SAMPLES], ptrs[P_PARAMS] = raw_queries.data_ptr(), pa.samples_flat.data_ptr(), params.data_ptr()
        ptrs[P_LAST_POLY], ptrs[P_TAB] = pa.last_poly.data_ptr(), table.data_ptr()
        ptrs[P_ANSWERS], ptrs[P_SELF_VALS], ptrs[P_LAST_EQ] = answers.data_ptr(), self_vals.data_ptr(), last_eq.data_ptr()
        scalars = _scalars(spec, batch, n_queries, len(qms))
        lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fold_phase((ctypes.c_int64 * N_SCALARS)(*scalars), (ctypes.c_int64 * N_PTRS)(*ptrs), stream)
    _raise_on(err, "fold_phase")
    if batch * n_queries:
        LAUNCHES["fold_phase"] += 1
    return answers, self_vals, last_eq.all(dim=1)


# ---------------------------------------------------------------------------
# bound: the int32 operations the fold phase needs, counted as
# ops/composition_cuda counts them (a modular add 3, a multiply 6, at 132
# SMs x 128 lanes x 1.98 GHz), with the per-proof quotient coefficients
# counted once a proof and each conditional point addition of the
# half-index chain counted where the query's bit asks for it; against the
# bytes of every input read once and every output written once.  A batch's
# numerator, the sum over its columns of C val - (A dy + B), is counted at
# its least form, sum of C val - (SA dy + SB) with SA and SB the per-proof
# sums of A and B: one M31 x QM31 product and add a column a slot.
# ---------------------------------------------------------------------------

_MINUS_2U = (False, False, True, False)  # limb flags of the constant -2u


class FoldOps(NamedTuple):
    per_proof: int  # the quotients' coefficients and their batch sums, rc powers and shift points
    per_slot: int  # everything else of one (proof, query) slot
    per_point_add: int  # one conditional addition of the half-index chain


def _point_double(o: _Ops):
    o.sub(o.mul(True, True), o.mul(True, True))
    o.add(o.mul(True, True), True)


def _fold(o: _Ops, v):
    d = o.q_mul_m31(o.q_sub(v, _Q), True)
    return o.q_add(o.q_add(v, _Q), o.q_mul(d, _Q))


@lru_cache(maxsize=None)
def fold_ops(spec) -> FoldOps:
    t = spec_tables(spec)
    proof, slot = _Ops(), _Ops()
    for first, n, cx, cy in t.batches:
        if (cx, cy) != IDENTITY:
            proof.q_sub(proof.q_mul_m31(_Q), proof.q_mul_m31(_Q))
            proof.q_add(proof.q_mul_m31(_Q), proof.q_mul_m31(_Q))
        for k in range(n):
            alpha = proof.q_mul(_Q, _MINUS_2U)
            proof.q_mul(_Q, _Q)  # the next power of rc
            v0y1, v1y0 = proof.c_mul((True, True), (True, True)), proof.c_mul((True, True), (True, True))
            b_c = (proof.sub(v0y1[0], v1y0[0]), proof.sub(v0y1[1], v1y0[1]))
            for s in ((True, True), (True, True), b_c):  # A, C and B
                proof.q_mul_cm31(alpha, s)
            if k:  # SA and SB
                proof.q_add(_Q, _Q)
                proof.q_add(_Q, _Q)
            # the slot's sum of C val
            slot.q_add(_Q, slot.q_mul_m31(_Q))
        # the denominator, its inverse and the batch's share: (sum of C val
        # - (SA dy + SB)) / denominator
        ta = slot.c_mul((slot.sub(True, True), True), (True, True))
        tb = slot.c_mul((slot.sub(True, True), True), (True, True))
        den = slot.c_inv((slot.sub(ta[0], tb[0]), slot.sub(ta[1], tb[1])))
        num = slot.q_sub(_Q, slot.q_add(slot.q_mul_m31(_Q), _Q))
        slot.q_add(_Q, slot.q_mul_cm31(num, den))
    M, n_inner = spec.max_first_layer_log, spec.n_inner_layers
    folded = _Z
    for L in spec.all_log_sizes:
        _point_double(slot)
        slot.neg(True)
        slot.inv(True)
        circle_fold = _fold(slot, _Q)
        if M - L < n_inner:
            folded = slot.q_add(slot.q_mul(folded, slot.q_mul(_Q, _Q)), circle_fold)
    for _ in range(n_inner):
        _point_double(slot)
        slot.inv(True)
        _fold(slot, _Q)
    d = spec.log_last_layer_degree_bound
    slot.sub(slot.mul(True, True), slot.mul(True, True))
    for _ in range(max(d - 1, 0)):
        slot.sub(slot.add(slot.mul(True, True), True), True)
    for _ in range((1 << d) - 1):
        slot.q_add(_Q, slot.q_mul_m31(_Q))
    add = _Ops()
    add.sub(add.mul(True, True), add.mul(True, True))
    add.add(add.mul(True, True), add.mul(True, True))
    return FoldOps(proof.int_ops, slot.int_ops, add.int_ops)


def point_adds(spec, raw_queries) -> int:
    """Conditional point additions the half-index chain of these queries
    makes: bits 1..M-1 of each masked query (A_M), and bits 1..n_inner (J
    on the way down)."""
    M = spec.max_first_layer_log
    q = np.asarray(torch.as_tensor(raw_queries).cpu(), dtype=np.int64) & ((1 << M) - 1)
    bits = [(q >> k) & 1 for k in range(1, M)] + [(q >> k) & 1 for k in range(1, spec.n_inner_layers + 1)]
    return int(sum(int(b.sum()) for b in bits))


def fold_bytes(spec, batch: int, n_queries: int) -> int:
    """Each input read once, each output written once."""
    t = spec_tables(spec)
    n_groups, n_inner = len(spec.all_log_sizes), spec.n_inner_layers
    n_columns = len({(block, place) for block, place, _ in t.columns})
    per_slot = 8 * (1 + n_columns + 4 * n_groups + 4 * n_inner)  # query, columns, siblings
    per_slot += 8 * 4 * (n_groups + n_inner) + 1  # answers, self values, the equality
    samples = len({s for _, _, s in t.columns})
    per_proof = 8 * 4 * (samples + 3 + n_inner + 1 + (1 << spec.log_last_layer_degree_bound))
    return batch * n_queries * per_slot + batch * per_proof


def fold_bound_ms(spec, raw_queries) -> tuple:
    """(milliseconds, "operations" or "bytes") for one launch on these
    (B, Q) raw queries."""
    batch, n_queries = raw_queries.shape
    o = fold_ops(spec)
    ops = (batch * o.per_proof + batch * n_queries * o.per_slot + point_adds(spec, raw_queries) * o.per_point_add)
    ops /= H100_INT_OPS_PER_S
    mem = fold_bytes(spec, batch, n_queries) / H100_BYTES_PER_S
    return (ops * 1e3, "operations") if ops >= mem else (mem * 1e3, "bytes")
