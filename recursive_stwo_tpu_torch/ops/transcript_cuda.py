"""ctypes wrapper of the transcript kernel (csrc/transcript.cu).

  replay(spec, pa, inputs) -> verifier.transcript.Replay
      the Fiat-Shamir transcript of a batch in one launch, on the Poseidon31
      channel of either flavour (PlonkWithPoseidon, or PlonkWithoutPoseidon
      for a NoPoseidonVerifierSpec): the digest chain over every mixed row,
      every draw, the OODS point, the public inputs' sum and the PoW and
      total-sum checks; the twin of what XLA compiled from
      recursive_stwo_tpu/verifier/transcript.py `digest_chain` (:97-122, the
      lax.scan at :121) and the batched draw (:159), with points.py
      `oods_point_from_t` and verify.py's input loop (:50-63).

It takes CUDA int64 tensors of canonical residues and raises on anything
else; the plain version is verifier/transcript.replay_plain.  The kernel
launches on the current stream of its tensors' device and does not
synchronise.  `LAUNCHES` counts its launches.

The kernel reads the proof arrays in place.  Its row table, built here on
the host and cached per spec (`row_table`), has a row for every operand row
of `build_operands` (or `build_operands_np`), in order: for each half of the
row (words 0-3, 4-7) a source (SOURCES, or CONST whose offset is word 0),
the element offset within a proof and the words read (the rest read 0); and
a row for every draw of `_draw_schedule` (or `_draw_schedule_np`): the row
it follows, n_sent, its first output column and the words it stores.  The
kernel runs each draw beside the permutation of the row after its own
(`draw_steps`), the draws after the last row two at a time, so a proof's
chain is `chain_steps` permutations, T + 1 on every spec here; `row_table`
refuses a schedule where two draws follow one row before the last.  The
kernel writes one (B, width) int64 row a proof (`Layout`), whose columns the
FSOutput's fields, the OODS point and the input sum are views of, and a
(B, 2) bool of the PoW and total-sum checks.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import torch

from ..core.qm31 import QM31
from ..verifier.spec import NoPoseidonVerifierSpec
from ..verifier.transcript_host import (
    FSOutput,
    _draw_schedule,
    _draw_schedule_np,
    n_last_poly_rows,
    n_rows,
    n_rows_np,
    n_sample_rows,
)
from . import build
from .composition_cuda import _M, _Q, _check_tensor, _Ops
from .poseidon_cuda import H100_BYTES_PER_S, H100_INT_OPS_PER_S, INT_OPS_PER_PERMUTATION, _raise_on

P = 2**31 - 1
LAUNCHES = {"transcript": 0}

# csrc/transcript.cu's sources (the ProofArrays fields a row may read), in
# its order; CONST reads its offset as word 0
SOURCES = ("commitments", "plonk_total_sum", "poseidon_total_sum", "samples_flat", "first_layer_commitment",
           "inner_commitments", "last_poly", "nonce_limbs")
(COMMITMENTS, PLONK_SUM, POSEIDON_SUM, SAMPLES, FIRST_LAYER, INNER, LAST_POLY, NONCE) = range(len(SOURCES))
CONST = len(SOURCES)
ZERO_HALF = (CONST, 0, 0)
# the positions of its `scalars` and `ptrs` arrays
(S_BATCH, S_ROWS, S_DRAWS, S_WIDTH, S_POW_COL, S_TAIL_COL, S_INPUTS, S_POW_BITS, S_WITH_POSEIDON,
 S_STRIDE) = range(10)
N_SCALARS = S_STRIDE + len(SOURCES)
P_SRC = 0
P_TAB, P_INPUTS, P_OUT, P_OK = range(len(SOURCES), len(SOURCES) + 4)
N_PTRS = P_OK + 1
# the kernel's fixed output columns: z, alpha, random_coeff, oods_t, the
# after-sampled-values coefficient, then the FRI alphas
Z_COL, ALPHA_COL, RC_COL, OODS_T_COL, AFTER_COL, FRI_COL = 0, 4, 8, 12, 16, 20
MAX_OFFSET = 2**31 - 1  # a row table entry is an int32
# the row and draw table the kernel stages in shared memory: 48 KB a block,
# less its round constants (csrc/transcript.cu kMaxTableBytes)
MAX_TABLE_BYTES = 48 * 1024 - 8 * 4 * 16


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class Layout(NamedTuple):
    """The columns of the kernel's (B, width) output row."""

    queries: int  # the n_queries raw queries
    pow: int  # the post-nonce digest's word 0
    tail: int  # OODS x, OODS y, the input sum: 4 columns each
    width: int


class RowTable(NamedTuple):
    rows: tuple  # ((source, offset, words), (source, offset, words)) a mixed row
    draws: tuple  # (row, n_sent, first column, words) a draw
    layout: Layout
    with_poseidon: bool


def layout(spec) -> Layout:
    queries = FRI_COL + 4 * (spec.n_inner_layers + 1)
    pow_col = queries + spec.n_queries
    return Layout(queries, pow_col, pow_col + 1, pow_col + 13)


def _words(source: int, offset: int) -> tuple:
    """A row of 8 consecutive elements of a source."""
    return (source, offset, 4), (source, offset + 4, 4)


def _pairs(source: int, n_values: int, n_rows_: int) -> list:
    """Rows of (value 2k ‖ value 2k + 1) of an (n_values, 4) source, the
    half past an odd count reading 0."""
    return [((source, 8 * k, 4), (source, 8 * k + 4, 4) if 2 * k + 1 < n_values else ZERO_HALF)
            for k in range(n_rows_)]


@lru_cache(maxsize=None)
def row_table(spec) -> RowTable:
    """The kernel's row table of `spec` (see the module docstring)."""
    with_poseidon = not isinstance(spec, NoPoseidonVerifierSpec)
    const = [((CONST, int(v), 1), ZERO_HALF) for v in
             ((spec.log_size_plonk, spec.log_size_poseidon) if with_poseidon else (spec.log_size,))]
    sums = ((PLONK_SUM, 0, 4), (POSEIDON_SUM, 0, 4) if with_poseidon else ZERO_HALF)
    rows = [_words(COMMITMENTS, 0), *const, _words(COMMITMENTS, 8), sums, _words(COMMITMENTS, 16),
            _words(COMMITMENTS, 24)]
    rows += _pairs(SAMPLES, spec.total_samples, n_sample_rows(spec))
    rows.append(_words(FIRST_LAYER, 0))
    rows += [_words(INNER, 8 * i) for i in range(spec.n_inner_layers)]
    rows += _pairs(LAST_POLY, 1 << spec.log_last_layer_degree_bound, n_last_poly_rows(spec))
    rows.append(((NONCE, 0, 3), ZERO_HALF))
    expected = n_rows(spec) if with_poseidon else n_rows_np(spec)
    if len(rows) != expected:
        raise ValueError(f"row table of {len(rows)} rows, the transcript has {expected}")

    out = layout(spec)
    sched = _draw_schedule(spec) if with_poseidon else _draw_schedule_np(spec)
    n_fixed = 5 + spec.n_inner_layers  # z and alpha, then one QM31 a draw
    draws = []
    for d, (row, n_sent) in enumerate(sched):
        if d == 0:
            col, words = Z_COL, 8
        elif d < n_fixed:
            col, words = RC_COL + 4 * (d - 1), 4
        else:
            k = d - n_fixed
            col, words = out.queries + 8 * k, min(8, spec.n_queries - 8 * k)
        draws.append((row, n_sent, col, words))
    last = len(rows) - 1
    inner = [r for r, *_ in draws if r != last]
    if [r for r, *_ in draws] != inner + [last] * (len(draws) - len(inner)) or inner != sorted(set(inner)) or \
            (inner and inner[0] < 0):
        raise ValueError("the draw schedule does not pair each draw with the row after its own: every draw but "
                         "those after the last row must follow a row of its own, in order")
    return RowTable(tuple(rows), tuple(draws), out, with_poseidon)


def draw_steps(spec) -> tuple:
    """The kernel's schedule of the draws: for each draw, the step whose
    permutation it runs beside (the row after its own: row r's draw runs on
    the draws' quad while the chain's quad permutes row r + 1), the draws
    after the last row two at a time at steps T, T + 1, ... (one a quad)."""
    t = row_table(spec)
    n_rows = len(t.rows)
    steps, after_last = [], 0
    for row, *_ in t.draws:
        if row < n_rows - 1:
            steps.append(row + 1)
        else:
            steps.append(n_rows + after_last // 2)
            after_last += 1
    return tuple(steps)


def chain_steps(spec) -> int:
    """Permutations in a row on one proof's chain: the T rows, then the
    draws after the last row two at a time."""
    return max(len(row_table(spec).rows), max(draw_steps(spec)) + 1)


@lru_cache(maxsize=None)
def _device_table(spec, device) -> torch.Tensor:
    t = row_table(spec)
    flat = [v for row in t.rows for half in row for v in half] + [v for d in t.draws for v in d]
    return torch.tensor(flat, dtype=torch.int32, device=device)


@lru_cache(maxsize=64)
def _device_inputs(inputs: tuple, device) -> torch.Tensor:
    """The (n_inputs, 5) int64 table of public inputs (index, value limbs),
    each reduced mod p as the plain version's field operations reduce it."""
    return torch.tensor([[i % P] + [v % P for v in val] for i, val in inputs], dtype=torch.int64,
                        device=device).reshape(len(inputs), 5)


def _source_shapes(spec, batch: int) -> tuple:
    return ((batch, 4, 8), (batch, 4), (batch, 4), (batch, spec.total_samples, 4), (batch, 8),
            (batch, spec.n_inner_layers, 8), (batch, 1 << spec.log_last_layer_degree_bound, 4), (batch, 3))


def _check_shape(spec) -> None:
    t = row_table(spec)
    per_proof = max(4 * spec.total_samples, 8 * spec.n_inner_layers, 4 << spec.log_last_layer_degree_bound)
    if not (0 <= spec.pow_bits <= 32 and spec.n_queries >= 1 and per_proof <= MAX_OFFSET
            and 4 * (6 * len(t.rows) + 4 * len(t.draws)) <= MAX_TABLE_BYTES and t.layout.width <= MAX_OFFSET):
        raise ValueError(f"the transcript kernel takes no spec of pow {spec.pow_bits}, {spec.n_queries} queries, "
                         f"{spec.total_samples} samples and {len(t.rows)} rows")


def transcript(spec, pa, inputs) -> tuple:
    """The kernel on a batch: `pa` the batch's ProofArrays of CUDA int64
    tensors, `inputs` the public inputs ((index, (four limbs)), ...).
    Returns the (B, width) output rows and the (B, 2) bool checks."""
    _check_shape(spec)
    t = row_table(spec)
    batch = pa.commitments.shape[0]
    dev = pa.commitments.device
    ptrs = [0] * N_PTRS
    strides = [0] * len(SOURCES)
    for k, (name, shape) in enumerate(zip(SOURCES, _source_shapes(spec, batch))):
        if k == POSEIDON_SUM and not t.with_poseidon:
            continue  # the without-Poseidon rows never read it
        x = getattr(pa, name)
        _check_tensor(x, name, shape, dev)
        ptrs[P_SRC + k] = x.data_ptr()
        strides[k] = x.stride(0)
    inputs = tuple((int(i), tuple(int(v) for v in val)) for i, val in inputs)
    if any(len(val) != 4 for _, val in inputs):
        raise ValueError("a public input's value must have four limbs")
    table = _device_table(spec, dev)
    inp = _device_inputs(inputs, dev)
    out = torch.empty((batch, t.layout.width), dtype=torch.int64, device=dev)
    ok = torch.empty((batch, 2), dtype=torch.bool, device=dev)
    ptrs[P_TAB], ptrs[P_INPUTS], ptrs[P_OUT], ptrs[P_OK] = table.data_ptr(), inp.data_ptr(), out.data_ptr(), ok.data_ptr()
    s = [0] * N_SCALARS
    s[S_BATCH], s[S_ROWS], s[S_DRAWS], s[S_WIDTH] = batch, len(t.rows), len(t.draws), t.layout.width
    s[S_POW_COL], s[S_TAIL_COL], s[S_INPUTS], s[S_POW_BITS] = t.layout.pow, t.layout.tail, len(inputs), spec.pow_bits
    s[S_WITH_POSEIDON] = int(t.with_poseidon)
    s[S_STRIDE:S_STRIDE + len(SOURCES)] = strides
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.transcript_replay((ctypes.c_int64 * N_SCALARS)(*s), (ctypes.c_int64 * N_PTRS)(*ptrs), stream)
    _raise_on(err, "transcript_replay")
    if batch:
        LAUNCHES["transcript"] += 1
    return out, ok


def _qm31(out: torch.Tensor, col: int) -> QM31:
    return QM31(*(out[:, col + k] for k in range(4)))


def views(spec, out: torch.Tensor, ok: torch.Tensor):
    """The kernel's (B, width) rows and (B, 2) checks as the plain version
    returns them: a verifier.transcript.Replay of views."""
    from ..verifier.transcript import Replay

    lay = layout(spec)
    fs = FSOutput(
        z=_qm31(out, Z_COL),
        alpha=_qm31(out, ALPHA_COL),
        random_coeff=_qm31(out, RC_COL),
        oods_t=_qm31(out, OODS_T_COL),
        after_sampled_values_random_coeff=_qm31(out, AFTER_COL),
        fri_alphas=tuple(_qm31(out, FRI_COL + 4 * i) for i in range(spec.n_inner_layers + 1)),
        raw_queries=out[:, lay.queries:lay.queries + spec.n_queries],
        pow_digest0=out[:, lay.pow],
    )
    oods = (_qm31(out, lay.tail), _qm31(out, lay.tail + 4))
    return Replay(fs, oods, _qm31(out, lay.tail + 8), ok[:, 0], ok[:, 1])


def replay(spec, pa, inputs):
    """The transcript kernel on a batch, its outputs as the plain version
    (verifier/transcript.replay_plain) returns them."""
    return views(spec, *transcript(spec, pa, inputs))


# ---------------------------------------------------------------------------
# bound: the int32 operations of T + D permutations a proof
# (poseidon_cuda.INT_OPS_PER_PERMUTATION) and of the scalar tail, counted
# with ops/composition_cuda's counter (a modular add 3, a multiply 6), at
# 132 SMs x 128 lanes x 1.98 GHz; against the bytes of every operand word
# read once and every output written once.  The kernel is bound by the
# latency of a proof's chain_steps(spec) permutations in a row (the latency
# floor below) well above either.
# ---------------------------------------------------------------------------


def tail_ops(spec, n_inputs: int) -> int:
    """int32 operations of one proof's tail: the OODS point, the input sum
    and the total-sum sum."""
    o = _Ops()
    t2 = o.q_mul(_Q, _Q)
    den = o.q_inv(o.q_add(t2, _M))
    o.q_mul(o.q_sub(_M, t2), den)
    o.q_mul(o.q_add(_Q, _Q), den)
    for _ in range(n_inputs):
        o.q_add(_Q, o.q_inv(o.q_sub(o.q_add(_Q, o.q_mul_m31(_Q)), _Q)))
    for _ in range(2 if row_table(spec).with_poseidon else 1):
        o.q_add(_Q, _Q)
    return o.int_ops


def permutations(spec) -> int:
    """Permutations a proof's transcript computes: T rows and D draws."""
    t = row_table(spec)
    return len(t.rows) + len(t.draws)


def transcript_ops(spec, n_inputs: int) -> int:
    """int32 operations of one proof's transcript."""
    return permutations(spec) * INT_OPS_PER_PERMUTATION + tail_ops(spec, n_inputs)


def transcript_bytes(spec, batch: int, n_inputs: int) -> int:
    """Each operand word read once (the row table's), each output written
    once; the row table and the inputs read once a launch."""
    t = row_table(spec)
    words = sum(n for row in t.rows for src, _, n in row if src != CONST)
    per_proof = 8 * words + 8 * t.layout.width + 2
    return batch * per_proof + 4 * (6 * len(t.rows) + 4 * len(t.draws)) + 8 * 5 * n_inputs


def transcript_bound_ms(spec, batch: int, n_inputs: int) -> tuple:
    """(milliseconds, "operations" or "bytes") for one launch of `batch` proofs."""
    ops = batch * transcript_ops(spec, n_inputs) / H100_INT_OPS_PER_S
    mem = transcript_bytes(spec, batch, n_inputs) / H100_BYTES_PER_S
    return (ops * 1e3, "operations") if ops >= mem else (mem * 1e3, "bytes")


# ---------------------------------------------------------------------------
# latency floor: one proof's chain of chain_steps(spec) permutations, each
# the critical path of csrc/poseidon2.cuh's quad form, read off the code
# in dependent steps of each kind (`lat`: ops/latency_cuda.step_latencies,
# cycles a step of m31.cuh's add and mul, a rotation and a shuffle on the
# card, and "ghz"):
#   quad_mds16: t0 -> t3 -> t5 -> t[0] (4 adds), quad_sum (2 shuffles and
#     2 adds), the last add;
#   a full round: the constant's add, pow5's 3 products, the mds;
#   the partial rounds: word 0's broadcast and add, then per round the next
#     S-box input x(r+1) = (S15(r) + rc) + rot(y(r)), ready when both y(r)'s
#     rotation and S15(r) are: S15(r) waits on y(r-1) through total, the
#     words, the lane-local sum and quad_sum (7 adds and 2 shuffles with
#     the constant's add); then the last round's total and words.
# ---------------------------------------------------------------------------


def permutation_cycles(lat: dict) -> float:
    """Cycles of one permutation's critical path."""
    a, m, s, rot = lat["add"], lat["mul"], lat["shfl"], lat["rot"]
    mds = 7 * a + 2 * s
    full = a + 3 * m + mds
    sum_path = 7 * a + 2 * s
    t = s + a  # x(0): word 0's broadcast and the constant
    ready = 4 * a + 2 * s + a  # S15(0) + rc, from the round's input words
    y_prev = None
    for r in range(14):
        y = t + 3 * m
        if r == 13:
            t = max(y, y_prev + sum_path - a) + 2 * a
            break
        nxt = ready if y_prev is None else y_prev + sum_path
        t, y_prev = max(nxt, y + rot) + a, y
    return mds + 8 * full + t


def latency_floor_ms(spec, lat: dict) -> float:
    """The latency floor of one launch: a proof's chain of chain_steps(spec)
    permutations, each permutation_cycles(lat), at lat["ghz"]."""
    return chain_steps(spec) * permutation_cycles(lat) / (lat["ghz"] * 1e6)
