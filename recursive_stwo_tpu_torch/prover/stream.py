"""Streamed (chunked) provers on the device: O(base-domain) device state.

Twin of recursive_stwo_tpu/prover/stream.py (`prove_streamed`,
`prove_np_streamed`, `StreamedTree` and their helpers).  The resident
provers (device_prove.py, prove_np.py) hold every LDE column until the
quotients are taken; at chain levels 12 and the last layer that is 54-69 GiB
of the card's 79.  Here the device holds the base-domain coefficients only:

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

The hashes are the resident trees': Poseidon31 through `commit._level`
(the Merkle level kernel on CUDA, one launch a level of a chunk, the
columns read in place as `rows` views), SHA-256 through
`core/sha256.sha256_level` (the SHA-256 tree-level kernel on CUDA); on the
CPU both take their plain versions.  The FRI folds are the resident
provers' (`fri.fold_layer`, one fold-layer launch a layer on CUDA).
Nothing falls back: a tile is evaluated on its source's device and an error
propagates.  The proofs are byte-identical to the JAX package's
(tests/test_torch_stream.py).  `chunk_log` and `cutoff` are keyword
arguments with the JAX defaults (its RSTPU_STREAM_CHUNK_LOG and
RSTPU_STREAM_CUTOFF); `prove` and `prove_np` never route here by size.
"""

from __future__ import annotations

import logging
from functools import partial
from typing import Dict, List

import numpy as np
import torch

from ..core import circle
from ..core import circle_host as ccircle
from ..core import m31
from ..core.sha256 import sha256_level
from ..ops import fft_cuda
from ..proof.containers import PcsConfig, PlonkWithoutPoseidonProof, PlonkWithPoseidonProof
from ..utils.spans import span
from ..verifier import composition as vcomp
from ..verifier import sha256_merkle
from ..verifier.arrays import require_device
from ..verifier.spec import PLONK_LOG_EXPAND, POSEIDON_LOG_EXPAND, NoPoseidonVerifierSpec, VerifierSpec
from . import air, circle_fft, commit, sample
from .arrays import to_device, to_numpy, trace_to_torch
from .commit import DeviceTree, Sha256DeviceTree
from .commit_host import CommittedTree, _hash_node_level
from .composition import composition_stage, qm31_scalar
from .device_prove import _domain_order
from .fri import _mix_felts, fri_tail
from .interaction import interaction_columns
from .prove import flavour
from .prove_host import _add_const, _assemble_samples, _oods_point
from .prove_np import _assemble_samples_np
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
    span checked against its stored summit digest."""

    def __init__(self, sources: Dict[int, object], chunk_log: int = CHUNK_LOG, cutoff: int = CUTOFF,
                 flavor: str = "p31"):
        if flavor not in ("p31", "sha256"):
            raise ValueError(f"unknown hash flavour {flavor!r}, expected 'p31' or 'sha256'")
        self.flavor = flavor
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
                    tops.append(self._host_node_level(tops[-1]))
        self._tops = tops  # index i: level K - i
        self._spans: Dict[int, Dict[int, np.ndarray]] = {}

    @property
    def root(self) -> np.ndarray:
        return self._tops[-1][0]

    def n_columns_per_log_size(self) -> Dict[int, int]:
        return {L: s.n_cols for L, s in self.sources.items()}

    # -- hashing ---------------------------------------------------------------

    def _level(self, children, cols) -> torch.Tensor:
        if self.flavor == "sha256":
            return sha256_level(children, cols)
        n = cols.shape[1] if children is None else children.shape[0] // 2
        return commit._level(children, cols, n)

    def _host_node_level(self, children: np.ndarray) -> np.ndarray:
        if self.flavor == "sha256":
            return sha256_merkle.hash_node_level(children, None)
        return _hash_node_level(children, None)

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
            h = self._level(h, cols)
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


def _res_tree(cols_by_log: Dict[int, torch.Tensor], flavor: str, chunk_log: int, cutoff: int):
    """Resident-column tree: streamed from _RES_STREAM_MIN up, the resident
    DeviceTree / Sha256DeviceTree below it."""
    if max(cols_by_log) >= _RES_STREAM_MIN:
        return StreamedTree({L: ResidentSource(c) for L, c in cols_by_log.items()}, chunk_log, cutoff, flavor)
    return (Sha256DeviceTree if flavor == "sha256" else DeviceTree)(cols_by_log)


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


def _streamed_tail(spec, config, channel, trees, group_evals, sampled_values, plog, flavor, chunk_log, cutoff):
    """The FRI phase (fri.fri_tail) with streamed layer trees."""
    return fri_tail(
        spec, config, channel, trees, group_evals, sampled_values, plog,
        partial(_res_tree, flavor=flavor, chunk_log=chunk_log, cutoff=cutoff),
    )


def _blocks_by_log(blocks, blowup: int) -> Dict[int, List[torch.Tensor]]:
    """Coefficient blocks in tree-major order, keyed by their LDE log."""
    out: Dict[int, List[torch.Tensor]] = {}
    for cfs in blocks:
        out.setdefault(cfs.shape[1].bit_length() - 1 + blowup, []).append(cfs)
    return out


# ---------------------------------------------------------------------------
# the provers (stream.py:737-1094)
# ---------------------------------------------------------------------------


def _stream_flavour(channel, tree_cls, device) -> tuple:
    """(channel, the StreamedTree flavour) of a ported flavour, picked by
    the channel and tree class as prove.flavour picks them."""
    channel, Tree = flavour(channel, tree_cls, device)
    return channel, "sha256" if Tree is Sha256DeviceTree else "p31"


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
    channel, flavor = _stream_flavour(channel, tree_cls, device)
    plog = progress or logging.getLogger(__name__).debug
    blowup = config.fri_config.log_blowup_factor
    tree = partial(StreamedTree, chunk_log=chunk_log, cutoff=cutoff, flavor=flavor)

    ta = trace_to_torch(trace, device)
    lp, lq = ta.log_plonk, ta.log_poseidon
    bound = max(lp + PLONK_LOG_EXPAND, lq + POSEIDON_LOG_EXPAND)
    spec = VerifierSpec(
        log_size_plonk=lp,
        log_size_poseidon=lq,
        pow_bits=config.pow_bits,
        log_last_layer_degree_bound=config.fri_config.log_last_layer_degree_bound,
        log_blowup_factor=blowup,
        n_queries=config.fri_config.n_queries,
        n_inner_layers=bound - 2 - config.fri_config.log_last_layer_degree_bound,
    )
    if spec.n_inner_layers != spec.expected_n_inner_layers:
        raise ValueError("the FRI config does not fit the trace's log sizes")
    dm1 = bound - 1

    # ---- base-domain coefficients: the only large persistent device state ----
    c = {
        key: circle_fft.interpolate(_domain_order(rows, log))
        for key, rows, log in (
            ("p_pre", ta.plonk_pre, lp), ("p_tr", ta.plonk_tr, lp),
            ("q_pre", ta.pos_pre, lq), ("q_tr", ta.pos_tr, lq),
        )
    }
    plog("base coefficients interpolated")

    tree0 = tree(_coeff_sources([(lp + blowup, c["p_pre"]), (lq + blowup, c["q_pre"])]))
    tree1 = tree(_coeff_sources([(lp + blowup, c["p_tr"]), (lq + blowup, c["q_tr"])]))
    channel.mix_root(tree0.root)
    plog("tree0 (preprocessed) committed")
    channel.mix_one_felt([lp, 0, 0, 0])
    channel.mix_one_felt([lq, 0, 0, 0])
    channel.mix_root(tree1.root)
    plog("tree1 (trace) committed")

    z4, alpha4 = channel.draw_felts()
    lookup = (qm31_scalar(z4), qm31_scalar(alpha4))

    # ---- interaction columns + tree 2 ----
    int_p, plonk_total = interaction_columns(ta.plonk_pre, ta.plonk_tr, lookup, vcomp.evaluate_plonk)
    int_q, pos_total = interaction_columns(ta.pos_pre, ta.pos_tr, lookup, vcomp.evaluate_poseidon)
    c["p_int"] = circle_fft.interpolate(_domain_order(int_p, lp))
    c["q_int"] = circle_fft.interpolate(_domain_order(int_q, lq))
    del ta, int_p, int_q
    plog("interaction columns generated")
    channel.mix_two_felts(plonk_total, pos_total)
    tree2 = tree(_coeff_sources([(lp + blowup, c["p_int"]), (lq + blowup, c["q_int"])]))
    channel.mix_root(tree2.root)
    plog("tree2 (interaction) committed")

    random_coeff4 = channel.draw_felt()

    # ---- composition polynomial + tree 3 ----
    c["split"] = composition_stage(
        spec,
        (
            ((c["p_pre"], c["p_tr"], c["p_int"]), qm31_scalar(plonk_total), lp, vcomp.evaluate_plonk),
            ((c["q_pre"], c["q_tr"], c["q_int"]), qm31_scalar(pos_total), lq, vcomp.evaluate_poseidon),
        ),
        lookup,
        qm31_scalar(random_coeff4),
    )
    plog("composition coefficients computed")
    tree3 = tree({dm1 + blowup: CoeffSource(c["split"], dm1 + blowup)})
    channel.mix_root(tree3.root)
    plog("tree3 (composition) committed")

    oods = _oods_point(channel.draw_felt())

    # ---- OODS samples ----
    order = ((0, "p", "p_pre"), (0, "q", "q_pre"), (1, "p", "p_tr"), (1, "q", "q_tr"),
             (2, "p", "p_int"), (2, "q", "q_int"), (3, "c", "split"))
    shifted = {log: _add_const(oods, ccircle.point_neg(ccircle.CanonicCoset(log).step())) for log in (lp, lq)}
    samples_at = sample.samples_at(
        {(t, tag): c[name] for t, tag, name in order}, oods,
        {(2, "p"): shifted[lp], (2, "q"): shifted[lq]},
    )
    sampled_values = _assemble_samples(spec, lp, lq, bound, samples_at)
    plog("OODS samples computed")
    _mix_felts(channel, [s for tree_ in sampled_values for col in tree_ for s in col])

    after_coeff4 = channel.draw_felt()

    # ---- FRI first-layer quotients (streamed), in tree-major block order ----
    samples_flat = np.concatenate([col for tree_ in sampled_values for col in tree_]).astype(np.uint32)
    group_evals = _streamed_group_evals(
        spec, _blocks_by_log([c[name] for _, _, name in order], blowup),
        answer_inputs(samples_flat, oods, after_coeff4, device), chunk_log, plog,
    )
    del c

    stark_proof = _streamed_tail(spec, config, channel, [tree0, tree1, tree2, tree3], group_evals,
                                 sampled_values, plog, flavor, chunk_log, cutoff)
    return PlonkWithPoseidonProof(
        log_size_plonk=lp,
        log_size_poseidon=lq,
        plonk_total_sum=np.array(plonk_total, np.uint32),
        poseidon_total_sum=np.array(pos_total, np.uint32),
        config=config,
        stark_proof=stark_proof,
    )


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
    channel, flavor = _stream_flavour(channel, tree_cls, device)
    plog = progress or logging.getLogger(__name__).debug
    tree = partial(StreamedTree, chunk_log=chunk_log, cutoff=cutoff, flavor=flavor)

    with span("prove.air"):
        pre_h, tr_h = air.np_columns(trace)
    L = pre_h.shape[1].bit_length() - 1
    if 1 << L != pre_h.shape[1]:
        raise ValueError(f"{pre_h.shape[1]} rows is not a power of two")
    blowup = config.fri_config.log_blowup_factor
    spec = NoPoseidonVerifierSpec.for_rows(L, config)
    bound = spec.composition_log_degree_bound
    dm1 = bound - 1
    with span("prove.upload"):
        pre, tr = to_device(pre_h, device), to_device(tr_h, device)
    del pre_h, tr_h

    c_pre = circle_fft.interpolate(_domain_order(pre, L))
    tree0 = tree({L + blowup: CoeffSource(c_pre, L + blowup)})
    channel.mix_root(tree0.root)
    plog("tree0 (preprocessed) committed")
    channel.mix_one_felt([L, 0, 0, 0])

    c_tr = circle_fft.interpolate(_domain_order(tr, L))
    tree1 = tree({L + blowup: CoeffSource(c_tr, L + blowup)})
    channel.mix_root(tree1.root)
    plog("tree1 (trace) committed")

    z4, alpha4 = channel.draw_felts()
    lookup = (qm31_scalar(z4), qm31_scalar(alpha4))
    inter, total = interaction_columns(pre, tr, lookup, vcomp.evaluate_plonk_np)
    c_int = circle_fft.interpolate(_domain_order(inter, L))
    del pre, tr, inter
    plog("interaction columns generated")
    channel.mix_one_felt(total)
    tree2 = tree({L + blowup: CoeffSource(c_int, L + blowup)})
    channel.mix_root(tree2.root)
    plog("tree2 (interaction) committed")

    random_coeff4 = channel.draw_felt()
    split = composition_stage(
        spec,
        (((c_pre, c_tr, c_int), qm31_scalar(total), L, vcomp.evaluate_plonk_np),),
        lookup,
        qm31_scalar(random_coeff4),
    )
    plog("composition coefficients computed")
    tree3 = tree({dm1 + blowup: CoeffSource(split, dm1 + blowup)})
    channel.mix_root(tree3.root)
    plog("tree3 (composition) committed")

    oods = _oods_point(channel.draw_felt())
    shifted = _add_const(oods, ccircle.point_neg(ccircle.CanonicCoset(L).step()))
    blocks = (c_pre, c_tr, c_int, split)
    samples_at = sample.samples_at(dict(enumerate(blocks)), oods, {2: shifted})
    sampled_values = _assemble_samples_np(spec, bound, samples_at)
    plog("OODS samples computed")
    _mix_felts(channel, [s for tree_ in sampled_values for col in tree_ for s in col])

    after_coeff4 = channel.draw_felt()
    samples_flat = np.concatenate([col for tree_ in sampled_values for col in tree_]).astype(np.uint32)
    group_evals = _streamed_group_evals(
        spec, _blocks_by_log(blocks, blowup), answer_inputs(samples_flat, oods, after_coeff4, device),
        chunk_log, plog,
    )
    del blocks, c_pre, c_tr, c_int, split

    stark_proof = _streamed_tail(spec, config, channel, [tree0, tree1, tree2, tree3], group_evals,
                                 sampled_values, plog, flavor, chunk_log, cutoff)
    return PlonkWithoutPoseidonProof(
        log_size=L,
        total_sum=np.array(total, np.uint32),
        config=config,
        stark_proof=stark_proof,
    )
