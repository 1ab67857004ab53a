"""Hash planning: every Poseidon-Merkle hash of the verifier in three batched
passes of word-major permutations.

Twin of recursive_stwo_tpu/verifier/hashplan.py.  Every walk compiles into a
straight-line program of micro-ops, each exactly one 16-word permutation
with selectable input wiring, and the programs are bin-packed into LANES
(4, the reference's default) lanes of near-equal length.  The reference
runs each packed pass as one jax.lax.scan over the steps.  Here a pass is
lowered once on the host to an op table (its layout is in
ops/poseidon_cuda.py) whose descriptors read the inputs in place: the
(8, N) digests, one level of the (B, Q, depth, 8) sibling hashes, an
8-column chunk of a (B, Q, n_cols) chain, the (B, Q) queries.  On CUDA the
pass is one launch of the scan kernel (`poseidon_cuda.wordmajor_scan`), the
carries held in registers for every step; on the CPU `scan_plain` runs the
same table step by step with the plain permutation.

States are word-major: a digest is an (8, N) tensor, N = B*Q (proof, query)
pairs flattened in row-major order.  The reference's (row, 128) tiling and
padding to 8-row multiples serve the TPU and are dropped: N is exact, so
there are no padded states.

Spans (utils/spans.py): `hash.absorb_lower` and `hash.walk_lower` lower a
pass to its op table on the host, `hash.scan` runs it (the table resolved,
uploaded and launched), `hash.leaf` is the leaves' one permutation.

Op wiring (one permutation P(l || r) per step, rate half kept):
  node     l,r = bit-ordered (carry_s | in_a at walk start,
                              carry_b | in_b sibling hash)
  selfcol  l,r = carry_s, in_a (column capacity digest)
  sibcol   l,r = in_a (sibling subtree hash), in_b (sibling capacity);
           result written to carry_b (dual-track FRI pair walks)
A walk's digest is carry_s after its last op.  Column-chain absorption
(digest = P(chunk || digest) capacity half, the carry zeroed at a chain's
first chunk) is the same scheme in `absorb_packed`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.poseidon2 import permute_wordmajor, permute_wordmajor_plain
from ..ops import poseidon_cuda
from ..ops.poseidon_cuda import (
    A_IN, ACTIVE, B_CARRY_B, B_CARRY_S, B_IN_A, B_IN_B, B_SEL_SHIFT, F_A, F_B, F_FLAGS,
    F_OUT, F_Q, FIELDS, START, SWAP, WRITE_B,
)
from ..utils.spans import span

LANES = 4


def _pack(progs: List[list]) -> List[list]:
    """Greedy: longest program first, each onto the currently shortest lane."""
    order = sorted(range(len(progs)), key=lambda i: -len(progs[i]))
    lane_prog: List[list] = [[] for _ in range(LANES)]
    for i in order:
        ln = min(range(LANES), key=lambda l: len(lane_prog[l]))
        lane_prog[ln].extend(progs[i])
    return lane_prog


# ---------------------------------------------------------------------------
# Lowering a pass to an op table
# ---------------------------------------------------------------------------

@dataclass
class ScanProgram:
    """One pass, lowered: the (LANES, T, FIELDS) int64 op table on the CPU,
    the tensors its descriptors read (kept alive until the pass has run),
    slots per lane, output slots, and which half of each permutation the
    carries keep."""
    ops: torch.Tensor
    sources: List[torch.Tensor]
    n: int
    n_out: int
    keep_capacity: bool
    device: torch.device


class _Sources:
    """The tensors a program reads, each listed once."""

    def __init__(self):
        self.tensors: List[torch.Tensor] = []
        self._index: Dict[int, tuple] = {}

    def add(self, x: torch.Tensor) -> tuple:
        """(index, strides) of x."""
        hit = self._index.get(id(x))
        if hit is None:
            hit = self._index[id(x)] = (len(self.tensors), x.stride())
            self.tensors.append(x)
        return hit


def _slots(x: torch.Tensor) -> torch.Tensor:
    """(B, Q, ...) -> (B*Q, ...), a view wherever the strides allow."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


# descriptors: (source, offset, stride_n, stride_w, n_words); queries:
# (source, offset, stride_n, level)
def _digest(src: _Sources, d: torch.Tensor) -> tuple:
    """An (8, N) digest."""
    i, (sw, sn) = src.add(d)
    return (i, 0, sn, sw, 8)


def _level(src: _Sources, sib: torch.Tensor, t: int) -> tuple:
    """Level t of (N, depth, 8) sibling hashes."""
    i, (sn, sl, sw) = src.add(sib)
    return (i, t * sl, sn, sw, 8)


def _chunk(src: _Sources, cols: torch.Tensor, k: int) -> tuple:
    """Columns 8k..8k+7 of (N, n_cols), those past n_cols reading as 0."""
    i, (sn, sw) = src.add(cols)
    return (i, 8 * k * sw, sn, sw, min(8, cols.shape[1] - 8 * k))


def _bits(src: _Sources, queries: torch.Tensor, level: int) -> tuple:
    """Bit `level` of (N,) query positions."""
    i, (sn,) = src.add(queries)
    return (i, 0, sn, level)


_NONE = [0, -1, -1, 0, 0, 0, 0, -1, 0, 0, 0, 0, -1, 0, 0, 0]  # an inactive op


def _op(a_in: bool, b_sel: int, in_a: Optional[tuple] = None, in_b: Optional[tuple] = None,
        bits: Optional[tuple] = None, write_b: bool = False, start: bool = False,
        out: int = -1) -> list:
    """One micro-op's row of the op table; the query bit swaps if `bits`."""
    row = list(_NONE)
    row[F_FLAGS] = (ACTIVE | (A_IN if a_in else 0) | b_sel << B_SEL_SHIFT | (WRITE_B if write_b else 0)
                    | (START if start else 0) | (SWAP if bits else 0))
    row[F_OUT] = out
    if in_a:
        row[F_A:F_A + 5] = in_a
    if in_b:
        row[F_B:F_B + 5] = in_b
    if bits:
        row[F_Q:F_Q + 4] = bits
    return row


def _lower(progs: List[list], src: _Sources, n: int, n_out: int, keep_capacity: bool,
           device) -> ScanProgram:
    lane_prog = _pack(progs)
    T = max(len(p) for p in lane_prog)
    table = [p + [_NONE] * (T - len(p)) for p in lane_prog]
    ops = torch.from_numpy(np.array(table, dtype=np.int64).reshape(LANES, T, FIELDS))
    return ScanProgram(ops, src.tensors, n, n_out, keep_capacity, torch.device(device))


# ---------------------------------------------------------------------------
# Running a pass
# ---------------------------------------------------------------------------

def _gather(prog: ScanProgram, d: list) -> torch.Tensor:
    src, off, sn, sw, nw = d
    x = prog.sources[src]
    g = torch.as_strided(x, (nw, prog.n), (sw, sn), x.storage_offset() + off)
    return torch.cat([g, g.new_zeros((8 - nw, prog.n))]) if nw < 8 else g


def step_inputs(prog: ScanProgram, ln: int, t: int):
    """(in_a, in_b, bit) of lane ln's op at step t, read through its
    descriptors: (8, n) tensors or None, an (n,) bool tensor or None."""
    row = prog.ops[ln, t].tolist()
    in_a, in_b = (_gather(prog, row[f:f + 5]) if row[f] >= 0 else None for f in (F_A, F_B))
    bit = None
    if row[F_Q] >= 0:
        src, off, sn, level = row[F_Q:F_Q + 4]
        x = prog.sources[src]
        bit = ((torch.as_strided(x, (prog.n,), (sn,), x.storage_offset() + off) >> level) & 1) != 0
    return in_a, in_b, bit


def scan_plain(prog: ScanProgram) -> torch.Tensor:
    """The plain version of the scan kernel: the same op table and
    descriptors, run step by step with permute_wordmajor_plain.  Returns the
    (n_out, 8, n) output table."""
    L, T, _ = prog.ops.shape
    flags = prog.ops[..., F_FLAGS].tolist()
    slot = prog.ops[..., F_OUT].tolist()
    ends = [next((t for t in range(T) if not flags[ln][t] & ACTIVE), T) for ln in range(L)]
    zero = torch.zeros((8, prog.n), dtype=torch.int64, device=prog.device)
    out = torch.zeros((prog.n_out, 8, prog.n), dtype=torch.int64, device=prog.device)
    carry_s, carry_b = [zero] * L, [zero] * L
    for t in range(max(ends, default=0)):
        active = [ln for ln in range(L) if t < ends[ln]]
        lefts, rights = [], []
        for ln in active:
            fl = flags[ln][t]
            in_a, in_b, bit = step_inputs(prog, ln, t)
            a = in_a if fl & A_IN else carry_s[ln]
            b = zero if fl & START else (carry_b[ln], in_a, in_b, carry_s[ln])[(fl >> B_SEL_SHIFT) & 3]
            if fl & SWAP:
                a, b = torch.where(bit, b, a), torch.where(bit, a, b)
            lefts.append(a)
            rights.append(b)
        state = permute_wordmajor_plain(torch.cat([torch.stack(lefts), torch.stack(rights)], dim=1))
        kept = state[:, 8:] if prog.keep_capacity else state[:, :8]
        for i, ln in enumerate(active):
            if flags[ln][t] & WRITE_B:
                carry_b[ln] = kept[i]
            else:
                carry_s[ln] = kept[i]
            if slot[ln][t] >= 0:
                out[slot[ln][t]] = carry_s[ln]
    return out


def run_scan(prog: ScanProgram) -> torch.Tensor:
    """The pass's (n_out, 8, n) output table: one launch of the scan kernel
    on CUDA, `scan_plain` on the CPU."""
    if prog.ops.shape[1] == 0:  # every chain empty: nothing to permute
        return torch.zeros((prog.n_out, 8, prog.n), dtype=torch.int64, device=prog.device)
    if prog.device.type == "cpu":
        return scan_plain(prog)
    return poseidon_cuda.wordmajor_scan(prog.ops, prog.sources, prog.n_out, prog.n,
                                        prog.keep_capacity)


# ---------------------------------------------------------------------------
# Packed column-capacity absorption
# ---------------------------------------------------------------------------

def absorb_program(chains: List[torch.Tensor]) -> ScanProgram:
    """The absorb pass over (B, Q, n_i) column chains: one op per 8-column
    chunk, a chain's first chunk starting from a zero capacity, its last
    writing the chain's output slot."""
    B, Q = chains[0].shape[:2]
    src = _Sources()
    progs = []
    for ci, c in enumerate(chains):
        cols = _slots(c)
        n = -(-c.shape[-1] // 8)
        progs.append([
            _op(True, B_CARRY_S, in_a=_chunk(src, cols, k), start=k == 0, out=ci if k == n - 1 else -1)
            for k in range(n)
        ])
    return _lower(progs, src, B * Q, len(chains), True, chains[0].device)


def absorb_packed(chains: List[torch.Tensor]) -> List[torch.Tensor]:
    """Capacity-absorb many (B, Q, n_i) column chains, one permutation per
    8-column chunk; returns per-chain (8, B*Q) capacity digests (zero for a
    chain with no columns)."""
    with span("hash.absorb_lower"):
        prog = absorb_program(chains)
    with span("hash.scan"):
        return list(run_scan(prog))


def leaf_rate_many(digests: List[torch.Tensor]) -> List[torch.Tensor]:
    """hash_node(None, cols) finalization = rate(permute([0^8 | cap])); one
    batched permutation for all leaves.  (8, N) in and out."""
    with span("hash.leaf"):
        stacked = torch.stack(digests)  # (W, 8, N)
        state = torch.cat([torch.zeros_like(stacked), stacked], dim=1)
        return list(permute_wordmajor(state)[:, :8])


# ---------------------------------------------------------------------------
# Packed walk scan
# ---------------------------------------------------------------------------

@dataclass
class SingleWalk:
    depth: int
    queries: torch.Tensor  # (B, Q) positions at depth
    sibling_hashes: torch.Tensor  # (B, Q, depth, 8)
    col_caps: Dict[int, torch.Tensor]  # level h -> (8, N) capacity digest
    leaf: torch.Tensor  # (8, N) leaf hash
    root: torch.Tensor  # (B, 8)


@dataclass
class PairWalk:
    depth: int
    queries: torch.Tensor  # (B, Q) at depth
    sibling_hashes: torch.Tensor  # (B, Q, depth-1, 8), consumed in step order
    self_caps: Dict[int, torch.Tensor]  # level -> (8, N) (verifier-computed)
    sib_caps: Dict[int, torch.Tensor]
    self_leaf: torch.Tensor  # (8, N)
    sib_leaf: torch.Tensor  # (8, N)
    root: torch.Tensor  # (B, 8)


def _single_prog(wk: SingleWalk, wi: int, src: _Sources) -> List[list]:
    """Straight-line micro-op program for a single-path walk."""
    d = wk.depth
    col_at = {d - 1 - h: cap for h, cap in wk.col_caps.items()}
    sib, queries = _slots(wk.sibling_hashes), _slots(wk.queries)
    steps = []
    for t in range(d):
        leaf = _digest(src, wk.leaf) if t == 0 else None
        steps.append(_op(t == 0, B_IN_B, leaf, _level(src, sib, t), _bits(src, queries, t)))
        if t in col_at:
            steps.append(_op(False, B_IN_A, _digest(src, col_at[t])))
    steps[-1][F_OUT] = wi
    return steps


def _pair_prog(wk: PairWalk, wi: int, src: _Sources) -> List[list]:
    """Dual-track FRI pair walk.  The sibling track value entering node
    step t is: sib_leaf (t=0), the raw per-step sibling hash (no columns
    at t-1), or P(sibling hash || sibling capacity) written to carry_b by
    a sibcol op (columns at t-1)."""
    d = wk.depth
    col_at = {d - 1 - h: (cap, wk.sib_caps[h]) for h, cap in wk.self_caps.items()}
    sib, queries = _slots(wk.sibling_hashes), _slots(wk.queries)
    steps = []
    for t in range(d):
        if t == 0:
            b_sel, in_b = B_IN_B, _digest(src, wk.sib_leaf)
        elif (t - 1) in col_at:
            b_sel, in_b = B_CARRY_B, None
        else:
            b_sel, in_b = B_IN_B, _level(src, sib, t - 1)
        leaf = _digest(src, wk.self_leaf) if t == 0 else None
        steps.append(_op(t == 0, b_sel, leaf, in_b, _bits(src, queries, t)))
        if t in col_at:
            scap, bcap = col_at[t]
            steps.append(_op(False, B_IN_A, _digest(src, scap)))
            steps.append(_op(True, B_IN_B, _level(src, sib, t), _digest(src, bcap), write_b=True))
    steps[-1][F_OUT] = wi
    return steps


def walk_program(singles: List[SingleWalk], pairs: List[PairWalk]) -> ScanProgram:
    """The walk pass: every walk from leaf to root, its digest to slot wi
    (singles first, then pairs)."""
    all_walks = list(singles) + list(pairs)
    B, Q = all_walks[0].queries.shape
    src = _Sources()
    progs = [_single_prog(wk, wi, src) for wi, wk in enumerate(singles)] + [
        _pair_prog(wk, wi + len(singles), src) for wi, wk in enumerate(pairs)
    ]
    return _lower(progs, src, B * Q, len(all_walks), False, all_walks[0].queries.device)


def walk_scan(singles: List[SingleWalk], pairs: List[PairWalk]):
    """Run every walk; returns (single_oks, pair_oks) of (B,) bools.

    Total permutations = sum over walks of (depth + column ops), packed into
    LANES lanes.  A walk's final carry digest is compared with its root."""
    all_walks = list(singles) + list(pairs)
    with span("hash.walk_lower"):
        prog = walk_program(singles, pairs)
    with span("hash.scan"):
        digests = run_scan(prog)
    oks = []
    for wi, wk in enumerate(all_walks):
        B, Q = wk.queries.shape
        dig = digests[wi].reshape(8, B, Q)
        oks.append((dig == wk.root.T[:, :, None]).all(dim=0).all(dim=-1))
    return oks[: len(singles)], oks[len(singles):]
