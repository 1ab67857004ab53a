"""Host copy of recursive_stwo_tpu/prover/fri.py (numpy only; its jax branches are
removed; `decommit_pair`'s plan and gathers are the port's `decommit.plan` and
`decommit.gather` spans, utils/spans.py).  The torch twin is fri.py beside it.

FRI commit + decommit (prover side).

Fold semantics are pinned by the verifier's replay
(verifier/hints.fold_circle_pair / fold_line_pair, fixture-validated):
circle fold (l+r) + a*(l-r)/y, line folds (l+r) + a*(l-r)/x on
half_odds cosets, no 1/2 normalization (each fold scales by 2; the last
polynomial interpolates the folded values, absorbing the scale).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List, Tuple

import numpy as np

from ..core import circle_host as ccircle
from ..core import m31_host as m31
from ..core import qm31_host as q
from ..core.qm31_host import QM31
from ..proof.containers import MerkleDecommitment
from ..utils.spans import span
from .commit_host import CommittedTree


@lru_cache(maxsize=None)
def circle_fold_yinv(log_size: int) -> np.ndarray:
    """1/y at the even (bit-reversed) positions of the circle domain."""
    from .circle_fft_host import domain_points_bit_reversed

    _, y = domain_points_bit_reversed(log_size)
    return m31.inv(y[0::2].copy())


@lru_cache(maxsize=None)
def line_fold_xinv(log_size: int) -> np.ndarray:
    """1/x at half_odds(log_size) bit-reversed even positions."""
    coset = ccircle.Coset.half_odds(log_size)
    n = 1 << log_size
    br = ccircle.bit_reverse_indices(log_size)[0::2]
    order = np.uint64(1) << np.uint64(31)
    idx = (
        np.uint64(coset.initial_index)
        + br.astype(np.uint64) * np.uint64(coset.step_index)
    ) % order
    xs, _ = ccircle.apoints_at_indices(idx)
    return m31.inv(xs)


def _q_limbs(v: QM31):
    """(4, N) M31 limb stack, staying on the input's backend."""
    return np.stack([np.asarray(c, np.uint32) for c in v])  # (4, N)


def _q_of_limbs(arr: np.ndarray) -> QM31:
    return QM31(arr[0], arr[1], arr[2], arr[3])


def fold_circle(evals: QM31, alpha4) -> QM31:
    n = evals.a.shape[0]
    log = n.bit_length() - 1
    yinv = circle_fold_yinv(log)
    l = QM31(*(c[0::2] for c in evals))
    r = QM31(*(c[1::2] for c in evals))
    f0 = q.q_add(l, r)
    f1 = q.q_mul_m31(q.q_sub(l, r), yinv)
    alpha = QM31(*(np.uint32(x) for x in alpha4))
    return q.q_add(f0, q.q_mul(f1, alpha))


def fold_line(evals: QM31, alpha4, log_size: int) -> QM31:
    xinv = line_fold_xinv(log_size)
    l = QM31(*(c[0::2] for c in evals))
    r = QM31(*(c[1::2] for c in evals))
    f0 = q.q_add(l, r)
    f1 = q.q_mul_m31(q.q_sub(l, r), xinv)
    alpha = QM31(*(np.uint32(x) for x in alpha4))
    return q.q_add(f0, q.q_mul(f1, alpha))


def line_interpolate(evals: QM31, log_size: int) -> np.ndarray:
    """Line-poly coefficients (N, 4) in the verifier's eval basis
    (LinePolyVar.eval_at_point: top split by x, deeper by pi(x) ladder)."""
    n = np.asarray(evals.a).shape[0]
    assert n == 1 << log_size
    coset = ccircle.Coset.half_odds(log_size)
    xs = np.array(
        [coset.at(ccircle.bit_reverse_index(i, log_size))[0] for i in range(n)],
        np.uint32,
    )
    v = _q_limbs(evals)  # (4, n)
    cur_x = xs
    half_inv = m31.inv(np.uint32(2))
    for layer in range(log_size):
        step = 1 << layer
        groups = n // (2 * step)
        g = v.reshape(4, groups, 2, step)
        a, b = g[:, :, 0, :], g[:, :, 1, :]
        tw = m31.inv(cur_x[0 : n // (1 << layer) : 2]).reshape(groups, 1)
        f0 = m31.mul(m31.add(a, b), half_inv)
        f1 = m31.mul(m31.mul(m31.sub(a, b), tw), half_inv)
        v = np.stack([f0, f1], axis=2).reshape(4, n)
        sq = m31.mul(cur_x[0::2], cur_x[0::2])
        cur_x = m31.sub(m31.add(sq, sq), np.uint32(1))
    # layered natural order has bit k ~ factor k (x, pi, ...); the verifier
    # basis wants bit (log-1-k) ~ factor k: bit-reverse the index
    idx = np.array(
        [ccircle.bit_reverse_index(i, log_size) for i in range(n)], np.int64
    )
    return v[:, idx].T.copy()  # (n, 4)


def line_eval_at(coeffs: np.ndarray, x: int):
    """Reference last-layer evaluation (verifier semantics) for self-tests."""
    P = (1 << 31) - 1
    n = coeffs.shape[0]
    log = n.bit_length() - 1
    doublings = []
    cx = x
    for _ in range(log):
        doublings.append(cx)
        cx = (2 * cx * cx - 1) % P
    from ..cs import scalar

    vals = [tuple(int(c) for c in row) for row in coeffs]
    for d in reversed(doublings):
        vals = [
            scalar.q_add(vals[2 * i], scalar.q_mul_m31(vals[2 * i + 1], d))
            for i in range(len(vals) // 2)
        ]
    return vals[0]


# ---------------------------------------------------------------------------
# Pair-tree decommitment (FRI layers)
# ---------------------------------------------------------------------------

def decommit_pair(
    tree: CommittedTree, leaf_queries: List[int]
) -> MerkleDecommitment:
    """Hash witness for the dual-track pair walk, in exactly the
    consumption order of verifier/hints.expand_pair_paths.

    Plan (index math) then batched gathers via `tree.level_rows`, so the
    same code serves host and device-resident trees."""
    with span("decommit.plan"):
        max_log = tree.max_log
        data_set = set(tree.columns_by_log)
        plan: List[Tuple[int, List[int]]] = []  # (levels index, node indices)

        queries = sorted(set(int(v) for v in leaf_queries))
        touched: set = set()  # nodes at the level below current with hashes
        for current in range(max_log, -1, -1):
            level_idx = max_log - current  # tree.levels index of `current`
            wanted: List[int] = []
            if current in data_set:
                new_touched = set()
                for qq in queries:
                    new_touched.add(qq)
                    new_touched.add(qq ^ 1)
                if current != max_log:
                    for qq in sorted(new_touched):
                        for idx in (qq << 1, (qq << 1) | 1):
                            if idx not in touched:
                                wanted.append(idx)
                                touched.add(idx)
                touched_next = new_touched
            else:
                assert current != max_log
                touched_next = set()
                for qq in queries:
                    touched_next.add(qq)
                    for idx in (qq << 1, (qq << 1) | 1):
                        if idx not in touched:
                            wanted.append(idx)
                            touched.add(idx)
            if wanted:
                plan.append((level_idx - 1, wanted))
            touched = touched_next
            queries = sorted({qq >> 1 for qq in queries})

    with span("decommit.gather"):
        hash_witness = [tree.level_rows(li, idx) for li, idx in plan]
    return MerkleDecommitment(
        hash_witness=(
            np.concatenate(hash_witness)
            if hash_witness
            else np.zeros((0, 8), np.uint32)
        ),
        column_witness=np.zeros(0, np.uint32),
    )


def gather_qm31(evals: QM31, positions: List[int]) -> np.ndarray:
    """(len(positions), 4) host rows of a (possibly device-resident) QM31
    eval vector — one batched gather per limb."""
    if not positions:
        return np.zeros((0, 4), np.uint32)
    idx = np.asarray(positions, np.int64)
    return np.stack(
        [np.asarray(c, np.uint32)[idx] for c in evals], axis=1
    )


def first_layer_witness(
    group_evals: Dict[int, QM31], raw_queries: List[int], max_log: int
) -> np.ndarray:
    """fri_witness for the first layer: sibling values the verifier cannot
    derive (order per verifier/hints.rebuild_first_layer_evals)."""
    rows: List[np.ndarray] = []
    for L in sorted(group_evals, reverse=True):
        evals = group_evals[L]
        qs = sorted({qq >> (max_log - L) for qq in raw_queries})
        covered = set(qs)
        positions: List[int] = []
        i = 0
        while i < len(qs):
            start = (qs[i] >> 1) << 1
            for pos in (start, start + 1):
                if pos not in covered:
                    positions.append(pos)
            i += 2 if (i + 1 < len(qs) and qs[i + 1] == start + 1) else 1
        rows.append(gather_qm31(evals, positions))
    return (
        np.concatenate(rows).reshape(-1, 4)
        if rows
        else np.zeros((0, 4), np.uint32)
    )


def inner_layer_witness(evals: QM31, queries: List[int]) -> np.ndarray:
    """fri_witness for an inner layer: sibling of each queried position not
    itself queried (sorted order, per verifier/hints.prepare inner loop)."""
    qs = sorted(set(queries))
    qset = set(qs)
    positions = [k ^ 1 for k in qs if (k ^ 1) not in qset]
    return gather_qm31(evals, positions).reshape(-1, 4)
