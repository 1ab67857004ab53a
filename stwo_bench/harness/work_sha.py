"""The SHA-256 work a proof in the Sha256MerkleChannel flavour needs,
counted from the configuration's shapes, never from the kernels that were
launched, and its least time on the card.

Frozen here so that a change to the program cannot move the yardstick.  A
SHA-256 compression is 2,296 int32 instructions (64 rounds and the message
schedule, as PERF.md's kernel table counts them for csrc/sha256.cu when the
benchmark took this count), at work.py's SM issue ceiling.  A message of n
bytes is ceil((n + 9) / 64) compressions (SHA-256's padding: a 1 bit, zeros,
the 64-bit length).  A leaf of k columns hashes 4k bytes, a node its two
32-byte children and then its 4k bytes of columns.  Where a count is unsure
it counts less: every node of the four commitment trees and of each FRI
layer's tree at or above the streamed trees' cutoff level (the levels below
it are hashed on the host), each once (no streamed recomputation for a
decommitment), and no grind.
"""

from __future__ import annotations

from .work import H100_INT32_ISSUE_PER_S

INT_OPS_PER_COMPRESSION = 2296


def compression_seconds(compressions: int) -> float:
    """The least time the card could take for `compressions`."""
    return compressions * INT_OPS_PER_COMPRESSION / H100_INT32_ISSUE_PER_S


def message_compressions(n_bytes: int) -> int:
    return (n_bytes + 9 + 63) // 64


def node_compressions(n_cols: int, has_children: bool) -> int:
    return message_compressions(64 * int(has_children) + 4 * n_cols)


def tree_compressions(depth: int, cols_by_log: dict, lowest: int) -> int:
    """Every node of levels depth..lowest of a tree of 2**depth leaves,
    columns of log size L entering the nodes of level L."""
    return sum((1 << level) * node_compressions(cols_by_log.get(level, 0), level < depth)
               for level in range(max(lowest, 0), depth + 1))


def prover_compressions(spec, cutoff: int) -> int:
    """One proof's compressions on the card: the four trees and every FRI
    layer's tree (the first layer four columns at each column size, inner
    layer i four columns at max log - 1 - i), down to level `cutoff`."""
    total = sum(tree_compressions(spec.tree_max_domain_log[t], dict(spec.n_columns_per_log_size[t]), cutoff)
                for t in range(4))
    m = spec.max_first_layer_log
    total += tree_compressions(m, {log: 4 for log in spec.all_log_sizes}, cutoff)
    total += sum(tree_compressions(m - 1 - i, {m - 1 - i: 4}, cutoff) for i in range(spec.n_inner_layers))
    return total
