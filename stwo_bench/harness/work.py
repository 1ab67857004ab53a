"""The work a verifier batch or a proof needs, counted from the workload's
shapes, never from the kernels that were launched, and the card's ceilings.

Frozen here so that a change to the program cannot move the yardstick.  The
operation weights are those of recursive_stwo_tpu_torch/ops/poseidon_cuda.py
(INT_OPS_PER_PERMUTATION) as they stood when the benchmark was defined: a
Poseidon2-16 permutation over M31 is 1,360 modular additions at 3 int32
instructions (the sum, the sum less p, their minimum), 426 modular products
at 6 (the widening product, the mask, the shift, the fold's sum, less p, the
minimum) and 210 rotations at 4.  Where a count is unsure it counts less:
only permutations are counted (no field arithmetic of the folds, quotients or
composition), a Merkle node shared by several queries once, and no grind.
"""

from __future__ import annotations

import numpy as np

INT_OPS_PER_PERMUTATION = 1360 * 3 + 426 * 6 + 210 * 4
# the SM's issue limit on an H100 SXM: 4 schedulers x 32 lanes a clock on
# each of 132 SMs at the 1.98 GHz boost clock; a ceiling, not a measured rate
H100_INT32_ISSUE_PER_S = 4 * 32 * 132 * 1.98e9
# HBM3 bandwidth of an H100 SXM (NVIDIA's data sheet)
H100_BYTES_PER_S = 3.35e12
M31_BYTES = 4  # a word of the field, however the program stores it


def perm_seconds(perms: int) -> float:
    """The least time the card could take for `perms` permutations."""
    return perms * INT_OPS_PER_PERMUTATION / H100_INT32_ISSUE_PER_S


def node_perms(n_cols: int, has_children: bool) -> int:
    """Permutations of one Poseidon31 Merkle node: the child pair, then the
    columns absorbed 8 at a time and one more to join them (stwo's
    Poseidon31MerkleHasher::hash_node)."""
    cols = (-(-n_cols // 8) + 1) if n_cols else 0
    return int(has_children) + cols


def tree_perms(depth: int, cols_by_log: dict) -> int:
    """Every node of a whole tree of 2**depth leaves, columns of log size L
    entering the nodes of level L."""
    return sum((1 << level) * node_perms(cols_by_log.get(level, 0), level < depth) for level in range(depth + 1))


def path_perms(depth: int, leaves, cols_by_log: dict, pairs: bool) -> int:
    """The nodes a verifier must hash to walk the given leaves of a tree up
    to its root, each distinct node once.  With `pairs` (a FRI layer's tree)
    every level that holds columns is opened at both positions of a pair."""
    pos = np.unique(np.asarray(leaves, np.int64))
    total = 0
    for level in range(depth, -1, -1):
        n_cols = cols_by_log.get(level, 0)
        if pairs and n_cols:
            pos = np.unique(np.concatenate([pos, pos ^ 1]))
        total += len(pos) * node_perms(n_cols, level < depth)
        pos = np.unique(pos >> 1)
    return total


def verifier_perms(spec, raw_queries, transcript_rows: int) -> int:
    """One proof's permutations: its transcript's rows and draws, the four
    commitment trees' paths and every FRI layer's pair paths."""
    m = spec.max_first_layer_log
    q = np.asarray(raw_queries, np.int64) & ((1 << m) - 1)
    total = transcript_rows
    for t in range(4):
        d = spec.tree_max_domain_log[t]
        total += path_perms(d, q >> (m - d), dict(spec.n_columns_per_log_size[t]), pairs=False)
    total += path_perms(m, q, {log: 4 for log in spec.all_log_sizes}, pairs=True)
    for i in range(spec.n_inner_layers):
        d = m - 1 - i
        total += path_perms(d, q >> (i + 1), {d: 4}, pairs=True)
    return total


def prover_perms(spec) -> int:
    """One proof's Merkle permutations: every node of the four trees and of
    every FRI layer's tree, each once (no streamed recomputation)."""
    total = sum(tree_perms(spec.tree_max_domain_log[t], dict(spec.n_columns_per_log_size[t])) for t in range(4))
    m = spec.max_first_layer_log
    total += tree_perms(m, {log: 4 for log in spec.all_log_sizes})
    total += sum(tree_perms(m - 1 - i, {m - 1 - i: 4}) for i in range(spec.n_inner_layers))
    return total


def words(arrays) -> int:
    """M31 words in a nest of arrays, tuples and dicts."""
    if arrays is None:
        return 0
    if isinstance(arrays, dict):
        return sum(words(v) for v in arrays.values())
    if isinstance(arrays, (tuple, list)):
        return sum(words(v) for v in arrays)
    return int(np.asarray(arrays).size)
