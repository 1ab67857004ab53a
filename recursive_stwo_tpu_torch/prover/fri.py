"""FRI commit phase with device-resident layers, and the proof's tail.

Twins of device_prove.py:572-623 (`_fold_line_jit`, `_join_commit_jit`) and
of `_fri_tail_device` (:864-980).  The folds and commits run on the device.
A layer's line fold and the next layer's join share their alpha, so
`fri_tail` folds a proof in spec.n_inner_layers + 1 calls of `fold_layer`,
each the next layer's whole accumulator: on CUDA one launch of the
fold-layer kernel (ops/fri_fold_cuda.py), which derives each point and its
inverse in registers; on the CPU the plain version, `fold_layer_plain`
(eager QM31 on 1/y and 1/x from tile points, prover/tiles.py, as the JAX
package's streamed folds take them, stream.py:667-729).
The last layer's interpolation and degree check stay on the layer's
device (prover/fri_last.py: on CUDA one launch of the last-layer kernel, and
only the kept coefficients and a count come back).  The query draws and the
decommit plans are the JAX package's host code.  The witness plans come from
the queries alone (prover/fri_plan.py: the positions fri_host's witness
functions gather, in their order, in work proportional to the queries), and
only those rows are gathered on the device.

`fri_tail`'s stages are spans (utils/spans.py): `fri.layers` from the
first-layer tree to the last layer's felts mixed (in it `fri.first_tree`,
each layer's `fri.fold`, `fri.layer_tree`, `channel.mix_root` and
`channel.draw`, then `fri.last_layer`), `fri.grind`, `fri.queries`, and
`fri.decommit` (in it `decommit.plan` for the host index plans and
`decommit.gather` for the device gathers).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..core import m31
from ..core import qm31 as q
from ..core.qm31 import QM31
from ..cs import scalar
from ..ops import fri_fold_cuda
from ..proof.containers import FriLayerProof, FriProof, StarkProof
from ..utils.spans import span
from . import fri_host as host_fri
from . import fri_last, fri_plan, tiles
from .arrays import to_numpy
from .composition import qm31_scalar

# tiles of 2**20 points at most for the fold inverses: host tables of 2**20
# and 2**(n-20), however large the domain
TILE_LOG = 20


def _fold(l: QM31, r: QM31, inv: torch.Tensor, alpha: QM31) -> QM31:
    """(l + r) + alpha * (l - r) * inv."""
    return q.q_add(q.q_add(l, r), q.q_mul(q.q_mul_m31(q.q_sub(l, r), inv), alpha))


def _halves(g: torch.Tensor):
    return QM31(*g[:, 0::2]), QM31(*g[:, 1::2])


def _fold_inverses(log_size: int, line: bool, device) -> torch.Tensor:
    """1/x (a half_odds line) or 1/y (a circle domain) at the even positions
    of the 2**log_size domain, on `device`: the points from tiles of
    2**min(log_size, TILE_LOG) (prover/tiles.py; even positions are never
    conjugated), in the order of fri_host.line_fold_xinv / circle_fold_yinv."""
    b = min(log_size, TILE_LOG)
    tx, ty, _ = tiles.tile_consts(log_size, b, line, device)
    bx, by = tiles.tile_bases(log_size, b, 0, 1 << (log_size - b), line, device)
    cx, cy = tiles.tile_points(bx, by, tx[0::2], ty[0::2], None)
    return m31.inv((cx if line else cy).reshape(-1))


def fold_line(g: torch.Tensor, alpha: QM31, log_size: int) -> torch.Tensor:
    """(4, 2**n) line evaluations on half_odds(n) -> (4, 2**(n-1))."""
    return torch.stack(list(_fold(*_halves(g), _fold_inverses(log_size, True, g.device), alpha)))


def fold_circle(g: torch.Tensor, alpha: QM31, log_size: int) -> torch.Tensor:
    """(4, 2**n) circle-domain evaluations -> (4, 2**(n-1)) line evaluations."""
    return torch.stack(list(_fold(*_halves(g), _fold_inverses(log_size, False, g.device), alpha)))


def fold_layer_plain(g, join, alpha: QM31, log_size: int) -> torch.Tensor:
    """The plain version of `fold_layer`: fold_line(g), fold_circle(join),
    or alpha**2 fold_line(g) + fold_circle(join), each input (4, 2**n)."""
    if join is None:
        return fold_line(g, alpha, log_size)
    fold_in = fold_circle(join, alpha, log_size)
    if g is None:
        return fold_in
    a2 = qm31_scalar(scalar.q_mul(alpha, alpha))
    return torch.stack(list(q.q_add(q.q_mul(QM31(*fold_line(g, alpha, log_size)), a2), QM31(*fold_in))))


def fold_layer(g, join, alpha: QM31, log_size: int) -> torch.Tensor:
    """The next FRI layer's (4, 2**(n-1)) accumulator from a layer of 2**n
    points: the line fold of g, the circle fold of the joining first-layer
    group, or alpha**2 times the one plus the other.  On CUDA one launch of
    the fold-layer kernel; on the CPU the plain version."""
    if (g if g is not None else join).device.type == "cpu":
        return fold_layer_plain(g, join, alpha, log_size)
    return fri_fold_cuda.fold_layer(g, join, alpha, log_size)


def _gather(g: torch.Tensor, positions: np.ndarray) -> np.ndarray:
    """(k, 4) host rows of (4, N) device limbs."""
    with span("decommit.gather"):
        idx = torch.as_tensor(positions, device=g.device)
        return to_numpy(g[:, idx].T).reshape(-1, 4)


def first_layer_witness(first_cols: Dict[int, torch.Tensor], raw_queries: List[int], max_log: int) -> np.ndarray:
    rows = []
    for L in sorted(first_cols, reverse=True):
        with span("decommit.plan"):
            positions = fri_plan.first_layer_positions(raw_queries, max_log, L)
        rows.append(_gather(first_cols[L], positions))
    return np.concatenate(rows).reshape(-1, 4)


def inner_layer_witness(g: torch.Tensor, queries: List[int]) -> np.ndarray:
    with span("decommit.plan"):
        positions = fri_plan.inner_layer_positions(queries)
    return _gather(g, positions)


def _mix_root(channel, tree) -> None:
    with span("channel.mix_root"):
        channel.mix_root(tree.root)


def _draw_alpha(channel) -> QM31:
    with span("channel.draw"):
        return qm31_scalar(channel.draw_felt())


def _mix_felts(channel, felts) -> None:
    for k in range(0, len(felts), 2):
        chunk = felts[k : k + 2]
        if len(chunk) == 1:
            channel.mix_one_felt(chunk[0])
        else:
            channel.mix_two_felts(chunk[0], chunk[1])


def fri_tail(
    spec, config, channel, trees, first_cols: Dict[int, torch.Tensor], sampled_values, plog, tree_cls
) -> StarkProof:
    """FRI phase over device-resident layers (mirrors prove._fri_tail, whose
    `tree_cls` picks the Merkle flavour of the first-layer and inner-layer
    trees as it does here); first_cols: L -> (4, 2**L) first-layer quotient
    limbs.  `tree_cls` is any callable from {log: (4, 2**log) limbs} to a
    committed tree (the streamed prover's stream the large layers)."""
    plog("FRI first-layer quotients computed")
    M = spec.max_first_layer_log
    with span("fri.layers"):
        with span("fri.first_tree"):
            first_tree = tree_cls(first_cols)
        _mix_root(channel, first_tree)
        alphas = [_draw_alpha(channel)]

        inner_trees = []
        inner_evals: List[torch.Tensor] = []
        # layer 0 is the largest group's circle fold; the group of log L joins
        # layer M - L with alphas[M - L], the alpha of the line fold before it
        with span("fri.fold"):
            g = fold_layer(None, first_cols[M], alphas[0], M)
        level = M - 1
        for i in range(spec.n_inner_layers):
            with span("fri.layer_tree"):
                tree_i = tree_cls({level: g})
            inner_trees.append(tree_i)
            inner_evals.append(g)
            _mix_root(channel, tree_i)
            alphas.append(_draw_alpha(channel))
            join = first_cols.get(level) if i + 1 < spec.n_inner_layers else None
            with span("fri.fold"):
                g = fold_layer(g, join, alphas[i + 1], level)
            level -= 1

        with span("fri.last_layer"):
            last_bound = config.fri_config.log_last_layer_degree_bound
            last_poly = fri_last.last_layer_poly(g, level, last_bound)
            _mix_felts(channel, last_poly)

    # ---- PoW + queries ----
    plog("FRI layers committed; grinding PoW")
    with span("fri.grind"):
        nonce = channel.grind_pow(config.pow_bits)
    plog("PoW ground")
    with span("fri.queries"):
        channel.mix_u64(nonce)
        raw_queries: List[int] = []
        for _ in range(-(-config.fri_config.n_queries // 8)):
            a, b = channel.draw_felts()
            raw_queries.extend(int(x) for x in a)
            raw_queries.extend(int(x) for x in b)
        raw_queries = [v & ((1 << M) - 1) for v in raw_queries[: config.fri_config.n_queries]]

    # ---- decommitments (host plans, device gathers) ----
    with span("fri.decommit"):
        queried_values, decommitments = [], []
        for tree in trees:
            vals, dec = tree.decommit([v >> (M - tree.max_log) for v in raw_queries])
            queried_values.append(vals)
            decommitments.append(dec)

        first_layer = FriLayerProof(
            fri_witness=first_layer_witness(first_cols, raw_queries, M),
            decommitment=host_fri.decommit_pair(first_tree, raw_queries),
            commitment=first_tree.root,
        )
        inner_layers = []
        cur_queries = [v >> 1 for v in raw_queries]
        for tree_i, g_i in zip(inner_trees, inner_evals):
            inner_layers.append(
                FriLayerProof(
                    fri_witness=inner_layer_witness(g_i, cur_queries),
                    decommitment=host_fri.decommit_pair(tree_i, cur_queries),
                    commitment=tree_i.root,
                )
            )
            cur_queries = [v >> 1 for v in cur_queries]
    plog("decommitments gathered")

    return StarkProof(
        commitments=np.stack([t.root for t in trees]),
        sampled_values=sampled_values,
        decommitments=decommitments,
        queried_values=queried_values,
        proof_of_work=nonce,
        fri_proof=FriProof(
            first_layer=first_layer,
            inner_layers=inner_layers,
            last_layer_poly=last_poly,
            last_layer_log_size=last_bound,
        ),
    )
