"""Host copy of recursive_stwo_tpu/prover/commit.py (numpy only; its jax branches are
removed; `decommit`'s two passes are the port's `decommit.plan` and
`decommit.gather` spans, utils/spans.py).  The torch twin is commit.py beside it.

Merkle commitment over mixed-size column evaluations (stwo layout).

A commitment tree holds M31 columns grouped by domain log size: level L of
the tree has 2^L nodes; a node absorbs (children-pair) then the columns of
log size L at its index (hash semantics identical to
verifier/hints.hash_node, fixture-validated).

`decommit` emits the shared-ancestor witness format the framework's own
hint expansion (`verifier.hints.expand_single_paths`) consumes — i.e. the
stwo `MerkleDecommitment { hash_witness, column_witness }` with
column_witness empty and all touched column values in the queried-values
stream.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..core import poseidon2_host as poseidon2
from ..proof.containers import MerkleDecommitment
from ..utils.spans import span


def _hash_leaf_level(columns: np.ndarray) -> np.ndarray:
    """(n_cols, N) -> (N, 8) leaf hashes (vectorized hash_node(None, cols))."""
    n_cols, N = columns.shape
    digest = np.zeros((N, 8), np.uint32)
    for ci in range(0, n_cols, 8):
        chunk = columns[ci : ci + 8].T  # (N, <=8)
        if chunk.shape[1] < 8:
            chunk = np.pad(chunk, ((0, 0), (0, 8 - chunk.shape[1])))
        digest = poseidon2.permute(
            np.concatenate([chunk.astype(np.uint32), digest], axis=1)
        )[:, 8:]
    return poseidon2.permute(
        np.concatenate([np.zeros((N, 8), np.uint32), digest], axis=1)
    )[:, :8]


def _hash_node_level(
    children: np.ndarray, columns: np.ndarray | None
) -> np.ndarray:
    """children (2N, 8) -> (N, 8); columns (n_cols, N) absorbed if given."""
    N = children.shape[0] // 2
    pairs = children.reshape(N, 16).astype(np.uint32)
    h = poseidon2.permute(pairs)[:, :8]
    if columns is not None and columns.shape[0]:
        digest = np.zeros((N, 8), np.uint32)
        n_cols = columns.shape[0]
        for ci in range(0, n_cols, 8):
            chunk = columns[ci : ci + 8].T
            if chunk.shape[1] < 8:
                chunk = np.pad(chunk, ((0, 0), (0, 8 - chunk.shape[1])))
            digest = poseidon2.permute(
                np.concatenate([chunk.astype(np.uint32), digest], axis=1)
            )[:, 8:]
        h = poseidon2.permute(np.concatenate([h, digest], axis=1))[:, :8]
    return h


class CommittedTree:
    """columns_by_log: {log_size: (n_cols, 2^log_size) uint32}."""

    def __init__(self, columns_by_log: Dict[int, np.ndarray]):
        self.columns_by_log = {
            int(k): np.asarray(v, np.uint32) for k, v in columns_by_log.items()
        }
        self.max_log = max(self.columns_by_log)
        self.levels: List[np.ndarray] = self._build_levels()
        assert self.levels[-1].shape[0] == 1

    @property
    def root(self) -> np.ndarray:
        return np.asarray(self.levels[-1][0])

    def n_columns_per_log_size(self) -> Dict[int, int]:
        return {L: c.shape[0] for L, c in self.columns_by_log.items()}

    # -- gather primitives (overridden by the device tree to avoid pulling
    #    whole levels off the accelerator) --------------------------------

    def level_rows(self, level_idx: int, indices: List[int]) -> np.ndarray:
        """(len(indices), 8) node hashes of tree level `level_idx`."""
        return np.asarray(self.levels[level_idx])[np.asarray(indices, np.int64)]

    def column_rows(self, log_size: int, indices: List[int]) -> np.ndarray:
        """(n_cols, len(indices)) column openings at the given positions."""
        cols = self.columns_by_log[log_size]
        return np.asarray(cols)[:, np.asarray(indices, np.int64)]

    def _build_levels(self) -> List[np.ndarray]:
        from ..utils import native

        if native.available() and (1 << self.max_log) >= 1 << 8:
            # AVX-512 16-way host hashing (~9M permutes/s) beats shipping
            # columns over the remote-TPU link; the device-resident
            # pipeline (DeviceTree) hashes on-device instead because its
            # columns already live there
            cols = {
                L: np.asarray(c, np.uint32)
                for L, c in self.columns_by_log.items()
            }
            levels = [native.poseidon_leaf_level(cols[self.max_log])]
            h = levels[0]
            for L in range(self.max_log - 1, -1, -1):
                h = native.poseidon_node_level(h, cols.get(L))
                levels.append(h)
            return levels
        levels = [_hash_leaf_level(self.columns_by_log[self.max_log])]
        h = levels[0]
        for L in range(self.max_log - 1, -1, -1):
            h = _hash_node_level(h, self.columns_by_log.get(L))
            levels.append(h)
        return levels

    def decommit(self, raw_queries: List[int]) -> Tuple[np.ndarray, MerkleDecommitment]:
        """(queried_values stream, decommitment) for the given (unsorted,
        possibly duplicated) leaf queries — inverse of
        verifier/hints.expand_single_paths.

        Two passes: a host-side index plan (pure query math), then batched
        gathers per level (`level_rows`/`column_rows`), so the same code
        path serves numpy levels and device-resident levels."""
        with span("decommit.plan"):
            queries = sorted(set(int(q) for q in raw_queries))

            # -- pass 1: plan ---------------------------------------------------
            value_plan: List[Tuple[int, List[int]]] = [(self.max_log, queries)]
            witness_plan: List[Tuple[int, List[int]]] = []  # (level_idx, sibs)
            computed = set(queries)  # node indices at the current level
            positions = queries
            for i in range(self.max_log):
                level_log = self.max_log - 1 - i
                has_cols = level_log in self.columns_by_log
                parents: List[int] = []
                sibs: List[int] = []
                seen = set()
                for position in positions:
                    parent = position >> 1
                    if parent in seen:
                        continue
                    seen.add(parent)
                    sibling = position ^ 1
                    if sibling not in computed:
                        sibs.append(sibling)
                    parents.append(parent)
                if has_cols and parents:
                    value_plan.append((level_log, parents))
                if sibs:
                    witness_plan.append((i, sibs))
                computed = seen
                positions = sorted(parents)

        with span("decommit.gather"):
            values: List[np.ndarray] = []
            for level_log, idx in value_plan:
                gathered = self.column_rows(level_log, idx)  # (n_cols, len(idx))
                values.append(gathered.T.reshape(-1))
            hash_witness = [
                self.level_rows(i, sibs) for i, sibs in witness_plan
            ]

        decommitment = MerkleDecommitment(
            hash_witness=(
                np.concatenate(hash_witness)
                if hash_witness
                else np.zeros((0, 8), np.uint32)
            ),
            column_witness=np.zeros(0, np.uint32),
        )
        return (
            np.concatenate(values).astype(np.uint32)
            if values
            else np.zeros(0, np.uint32)
        ), decommitment
