"""Streamed (chunked) provers on the device: O(base-domain) device state.

Twin of recursive_stwo_tpu/prover/stream.py (`prove_streamed`,
`prove_np_streamed`, `StreamedTree` and their helpers).  The resident
commitment (flow.py's `Resident`) holds every LDE column until the
quotients are taken; at chain levels 12 and the last layer that is 54-69 GiB
of the card's 79.  `Streamed`, the commitment the streamed provers hand
prover/flow.py's stages, holds the base-domain coefficients only:

* **Chunked evaluation.**  The LDE coefficients are the base coefficients
  zero-padded into the larger FFT basis (the stwo basis is nested), and every
  butterfly layer whose step exceeds the base size has a zero second
  operand, so each aligned output tile of base size is the base coefficients
  transformed with that tile's twiddles (`eval_tiles`).  A tile's points
  come from prover/tiles.py on the device, and the twiddles follow from
  them.  On CUDA a call is one launch of the circle FFT's tile entry
  (ops/fft_cuda.py), which derives the twiddles from each tile's base
  point; on the CPU the plain version, `_eval_tiles`.
* **Streamed Merkle commitment** (`StreamedTree`).  A chunk of 2**C leaf rows
  is evaluated and hashed, absorbing every column size it covers, down to
  its summit digests at level K; only levels K..0 leave the device.  A
  decommitment recomputes the spans it touches (2**(M-K) leaves each) and
  checks each against its stored summit, raising on a mismatch.
  The commit is one `tree.commit` span, each chunk in it a `stream.chunk`
  span and the top levels a `stream.host_levels` span; a span recomputed
  for a decommitment is a `stream.recompute` span (utils/spans.py).
* **Streamed quotients**: the first-layer quotients of a chunk are taken
  from its re-evaluated columns and never need the LDE whole: on CUDA one
  tile launch and one quotient-kernel call a chunk (prover/quotients.py).

The hashes are the resident trees': a StreamedTree takes its tree class's
`device_level` and `host_node_level` (prover/commit.py), for `DeviceTree`
the Merkle level kernel on CUDA (one launch a level of a chunk, the
columns read in place as `rows` views), for `Sha256DeviceTree` the SHA-256
tree-level kernel; on the CPU both take their plain versions.  The FRI
folds are the resident provers' (`fri.fold_layer`, one fold-layer launch a
layer on CUDA).
Nothing falls back: a tile is evaluated on its source's device and an error
propagates.  The proofs are byte-identical to the JAX package's
(tests/test_torch_stream.py).  `chunk_log` and `cutoff` are keyword
arguments with the JAX defaults (its RSTPU_STREAM_CHUNK_LOG and
RSTPU_STREAM_CUTOFF); `prove` and `prove_np` never route here by size.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..core import circle
from ..core import m31
from ..ops import fft_cuda
from ..proof.containers import PcsConfig, PlonkWithoutPoseidonProof, PlonkWithPoseidonProof
from ..utils.spans import span
from ..verifier.arrays import require_device
from .arrays import to_numpy
from .commit_host import CommittedTree
from .flow import NoPoseidonAir, PoseidonAir, prove_air
from .prove import flavour
from .quotients import answer_inputs, group_answers
from .tiles import TilePoints, circle_tiles

# the JAX package's defaults (stream.py:64-70): chunks of 2**20 leaf rows,
# summits at level 13
CHUNK_LOG = 20
CUTOFF = 13
# a resident-column tree (the FRI layers) streams from this log up and is a
# DeviceTree / Sha256DeviceTree below it (stream.py:74)
_RES_STREAM_MIN = 23


# ---------------------------------------------------------------------------
# tile evaluation (stream.py:143-200): the plain version, eager torch on
# core/m31.py, and the dispatch
# ---------------------------------------------------------------------------


def _tile_twiddles(cx, cy, b: int) -> List[torch.Tensor]:
    """Per-tile twiddle slices (layer k has trailing dim 2^(b-1-k)),
    circle_fft's twiddles restricted to the tile."""
    tws = [cy[..., 0::2]]
    cur = cx[..., 0::2]
    for _ in range(1, b):
        t = cur[..., 0::2]
        tws.append(t)
        cur = circle.apoint_double_x(t)
    return tws


def _eval_tiles(coeffs: torch.Tensor, tws, b: int, G: int) -> torch.Tensor:
    """Base coefficients (n_cols, 2^b) evaluated on G tiles at once ->
    (n_cols, G, 2^b): the restriction of circle_fft.evaluate over the
    zero-padded LDE basis to those tiles."""
    n = 1 << b
    v = coeffs[:, None, :].expand(coeffs.shape[0], G, n)
    for layer in reversed(range(b)):
        step = 1 << layer
        groups = n // (2 * step)
        g = v.reshape(v.shape[:-1] + (groups, 2, step))
        f0, f1 = g[..., 0, :], g[..., 1, :]
        tf1 = m31.mul(f1, tws[layer].reshape(G, groups, 1))
        v = torch.stack([m31.add(f0, tf1), m31.sub(f0, tf1)], dim=-2).reshape(v.shape)
    return v


def eval_tiles(blocks: List[torch.Tensor], tiles: TilePoints) -> torch.Tensor:
    """Base coefficient blocks (n_i, 2^b) evaluated on the G tiles of
    `tiles` -> (sum of n_i, G * 2^b), the blocks' rows in order: on CUDA one
    launch of the tile kernel, which reads the blocks in place; on the CPU
    the plain version."""
    if blocks[0].device.type != "cpu":
        return fft_cuda.eval_tiles(blocks, tiles.bx, tiles.by, tiles.tx, tiles.ty)
    coeffs = blocks[0] if len(blocks) == 1 else torch.cat(blocks)
    cx, cy = tiles.points()
    G = cx.shape[0]
    return _eval_tiles(coeffs, _tile_twiddles(cx, cy, tiles.b), tiles.b, G).reshape(coeffs.shape[0], G << tiles.b)


# ---------------------------------------------------------------------------
# column sources (stream.py:208-243)
# ---------------------------------------------------------------------------


class CoeffSource:
    """Columns given by base-domain FFT coefficients (n_cols, 2^b) on the
    device, evaluated on the 2^L domain tile by tile."""

    kind = "eval"

    def __init__(self, coeffs: torch.Tensor, L: int):
        self.dev = coeffs
        self.n_cols = int(coeffs.shape[0])
        self.b = int(coeffs.shape[1]).bit_length() - 1
        self.L = int(L)

    def values(self, t0: int, t1: int) -> torch.Tensor:
        """The columns' values on tiles [t0, t1), (n_cols, G * 2^b), in
        bit-reversed domain order."""
        return eval_tiles([self.dev], circle_tiles(self.L, self.b, t0, t1, self.dev.device))

    def rows(self, lo: int, hi: int) -> torch.Tensor:
        """(n_cols, hi - lo) values at positions [lo, hi) of the domain."""
        t0, t1 = lo >> self.b, ((hi - 1) >> self.b) + 1
        vals = self.values(t0, t1)
        return vals[:, lo - (t0 << self.b) : hi - (t0 << self.b)]


class ResidentSource:
    """Columns resident on the device as a full (n_cols, 2^L) tensor."""

    kind = "res"

    def __init__(self, cols: torch.Tensor):
        self.dev = cols
        self.n_cols = int(cols.shape[0])
        self.b = 0

    def rows(self, lo: int, hi: int) -> torch.Tensor:
        return self.dev[:, lo:hi]


class _ColShape:
    """Shape-only stand-in, so CommittedTree's decommit plans (which ask
    which log sizes hold columns) work without the columns."""

    def __init__(self, shape):
        self.shape = shape


# ---------------------------------------------------------------------------
# the streamed tree (stream.py:252-543)
# ---------------------------------------------------------------------------


class StreamedTree(CommittedTree):
    """Merkle tree committed by streaming chunks through the device.

    Device state after construction: the sources only (the summits are on
    the host).  `level_rows` / `column_rows` serve decommitments from the
    stored top levels (<= K) and from spans recomputed on demand (> K), each
    span checked against its stored summit digest.  `tree_cls`, a
    `DeviceTree` class, gives the hash."""

    def __init__(self, sources: Dict[int, object], tree_cls, chunk_log: int = CHUNK_LOG, cutoff: int = CUTOFF):
        self.tree_cls = tree_cls
        self.sources = {int(L): s for L, s in sources.items()}
        M = self.max_log = max(self.sources)
        min_col = min(self.sources)
        need = max(
            [M - L + s.b for L, s in self.sources.items() if s.kind == "eval"] + [M - min_col] + [1]
        )
        C = min(M, max(need, chunk_log))
        K = max(min(cutoff, min_col), M - C)
        self.C, self.K = C, K
        self.columns_by_log = {L: _ColShape((s.n_cols, 1 << L)) for L, s in self.sources.items()}

        with span("tree.commit"):
            summits = []
            for j in range(1 << (M - C)):
                with span("stream.chunk"):
                    summits.append(self._hash_span(C, j)[0])
            tops = [to_numpy(torch.cat(summits))]
            with span("stream.host_levels"):
                for _ in range(K):
                    tops.append(tree_cls.host_node_level(tops[-1], None))
        self._tops = tops  # index i: level K - i
        self._spans: Dict[int, Dict[int, np.ndarray]] = {}

    @property
    def root(self) -> np.ndarray:
        return self._tops[-1][0]

    def n_columns_per_log_size(self) -> Dict[int, int]:
        return {L: s.n_cols for L, s in self.sources.items()}

    # -- hashing ---------------------------------------------------------------

    def _hash_span(self, span_log: int, j: int, keep: bool = False):
        """Hash leaf rows [j * 2^span_log, (j+1) * 2^span_log) down to their
        digests at level K, absorbing every column size on the way.  Returns
        (level-K digests, {L: digests} for every level if `keep`)."""
        M, K = self.max_log, self.K
        h, levels = None, {}
        for L in range(M, K - 1, -1):
            src = self.sources.get(L)
            width = span_log - (M - L)
            cols = None if src is None else src.rows(j << width, (j + 1) << width)
            h = self.tree_cls.device_level(h, cols)
            if keep:
                levels[L] = h
        return h, levels

    # -- decommit primitives -------------------------------------------------

    def _span(self, log: int, s: int) -> np.ndarray:
        """Digests of span s at level `log` (> K), computed on first touch
        and checked against the committed summit."""
        if s not in self._spans.get(log, {}):
            K = self.K
            with span("stream.recompute"):
                top, levels = self._hash_span(self.max_log - K, s, keep=True)
                # the summit self-check: the recomputed span must match the
                # streamed commit (guards the chunked re-evaluation end to end)
                if not np.array_equal(to_numpy(top), self._tops[0][s : s + 1]):
                    raise RuntimeError(f"span {s} of the streamed tree does not hash to its committed summit")
                for L, h in levels.items():
                    if L > K:
                        self._spans.setdefault(L, {})[s] = to_numpy(h)
        return self._spans[log][s]

    def level_rows(self, level_idx: int, indices) -> np.ndarray:
        log = self.max_log - level_idx
        idx = np.asarray(indices, np.int64)
        if log <= self.K:
            return self._tops[self.K - log][idx]
        out = np.empty((idx.size, 8), np.uint32)
        shift = log - self.K
        for i, v in enumerate(idx):
            s = int(v) >> shift
            out[i] = self._span(log, s)[int(v) - (s << shift)]
        return out

    def column_rows(self, log_size: int, indices) -> np.ndarray:
        src = self.sources[log_size]
        idx = np.asarray(indices, np.int64)
        if src.kind == "res":
            return to_numpy(src.dev[:, torch.as_tensor(idx, device=src.dev.device)])
        out = np.empty((src.n_cols, idx.size), np.uint32)
        tiles = idx >> src.b
        for t in np.unique(tiles):
            sel = np.nonzero(tiles == t)[0]
            vals = src.values(int(t), int(t) + 1)
            local = torch.as_tensor(idx[sel] - (int(t) << src.b), device=vals.device)
            out[:, sel] = to_numpy(vals[:, local])
        return out


def _coeff_sources(pairs) -> Dict[int, CoeffSource]:
    """[(L, coeffs), ...] -> {L: CoeffSource}, concatenating blocks that
    share a domain log in call order (plonk before poseidon, as
    commit.merge_by_log does for the resident trees when lp == lq)."""
    by: Dict[int, list] = {}
    for L, c in pairs:
        by.setdefault(int(L), []).append(c)
    return {L: CoeffSource(blocks[0] if len(blocks) == 1 else torch.cat(blocks), L) for L, blocks in by.items()}


def _res_tree(cols_by_log: Dict[int, torch.Tensor], tree_cls, chunk_log: int, cutoff: int):
    """Resident-column tree: streamed from _RES_STREAM_MIN up, a `tree_cls`
    tree below it."""
    if max(cols_by_log) >= _RES_STREAM_MIN:
        return StreamedTree({L: ResidentSource(c) for L, c in cols_by_log.items()}, tree_cls, chunk_log, cutoff)
    return tree_cls(cols_by_log)


# ---------------------------------------------------------------------------
# streamed quotients (stream.py:585-658)
# ---------------------------------------------------------------------------


def _streamed_group_evals(spec, blocks_by_log: Dict[int, List[torch.Tensor]], inputs, chunk_log: int,
                          plog) -> Dict[int, torch.Tensor]:
    """blocks_by_log: {log: [coefficient blocks in tree-major order]}.
    Returns the first-layer quotients {log: (4, 2^log) limbs}, resident,
    each chunk's columns re-evaluated from the coefficients: a tile
    evaluation of the group's blocks as they are and a quotient call a
    chunk, written in place."""
    group_evals = {}
    for g, L in enumerate(spec.all_log_sizes):
        blocks = blocks_by_log[L]
        b = int(blocks[0].shape[1]).bit_length() - 1
        Cq = min(L, max(b, chunk_log))
        G = 1 << (Cq - b)
        dev = blocks[0].device
        out = torch.empty((4, 1 << L), dtype=torch.int64, device=dev)
        for j in range(1 << (L - Cq)):
            tiles = circle_tiles(L, b, j * G, (j + 1) * G, dev)
            group_answers(spec, g, inputs, [eval_tiles(blocks, tiles)], tiles, out=out[:, j << Cq : (j + 1) << Cq])
        group_evals[L] = out
        plog(f"quotients at log {L} streamed")
    return group_evals


class Streamed:
    """The streamed commitment of prover/flow.py: StreamedTrees of `tree_cls`
    over base coefficients; the first-layer quotients re-evaluate the
    trees' coefficient blocks chunk by chunk; FRI layers from
    _RES_STREAM_MIN up streamed too (`_res_tree`)."""

    def __init__(self, tree_cls, chunk_log: int, cutoff: int):
        self.tree_cls, self.chunk_log, self.cutoff = tree_cls, chunk_log, cutoff

    def commit(self, blocks) -> StreamedTree:
        """[(LDE log, base coefficients), ...] -> their streamed tree."""
        return StreamedTree(_coeff_sources(blocks), self.tree_cls, self.chunk_log, self.cutoff)

    @staticmethod
    def columns(tree: StreamedTree) -> Dict[int, torch.Tensor]:
        return {L: s.dev for L, s in tree.sources.items()}

    def quotients(self, spec, blocks_by_log, samples_flat, oods, after_coeff, plog):
        device = next(iter(blocks_by_log.values()))[0].device
        inputs = answer_inputs(samples_flat, oods, after_coeff, device)
        return _streamed_group_evals(spec, blocks_by_log, inputs, self.chunk_log, plog)

    def layer_tree(self, cols_by_log: Dict[int, torch.Tensor]):
        return _res_tree(cols_by_log, self.tree_cls, self.chunk_log, self.cutoff)


# ---------------------------------------------------------------------------
# the provers (stream.py:737-1094)
# ---------------------------------------------------------------------------


def prove_streamed(
    trace: dict,
    config: PcsConfig,
    progress=None,
    device="cuda",
    channel=None,
    tree_cls=None,
    chunk_log: int = CHUNK_LOG,
    cutoff: int = CUTOFF,
) -> PlonkWithPoseidonProof:
    """Prove a PlonkWithPoseidon trace streamed on `device`: `channel` /
    `tree_cls` pick the flavour as prove's do, the Poseidon31 default or
    (`Sha256ProverChannel()`, `Sha256DeviceTree`) for Sha256Poseidon31,
    whose trees stream in SHA-256.  Byte for byte the proof of `prove` with
    the same flavour."""
    device = require_device(device)
    channel, tree_cls = flavour(channel, tree_cls, device)
    return prove_air(PoseidonAir(), Streamed(tree_cls, chunk_log, cutoff), trace, config, progress, device, channel)


def prove_np_streamed(
    trace: dict,
    config: PcsConfig,
    progress=None,
    device="cuda",
    channel=None,
    tree_cls=None,
    chunk_log: int = CHUNK_LOG,
    cutoff: int = CUTOFF,
) -> PlonkWithoutPoseidonProof:
    """The streamed twin of prove_np (the PlonkWithoutPoseidon AIR, the last
    layer's output system): `channel` / `tree_cls` pick the flavour as
    prove_np's do, the Poseidon31 default or (`Sha256ProverChannel()`,
    `Sha256DeviceTree`) for the Sha256MerkleChannel flavour, whose trees
    stream in SHA-256.  Byte for byte the proof of `prove_np`."""
    device = require_device(device)
    channel, tree_cls = flavour(channel, tree_cls, device)
    return prove_air(NoPoseidonAir(), Streamed(tree_cls, chunk_log, cutoff), trace, config, progress, device,
                     channel)
