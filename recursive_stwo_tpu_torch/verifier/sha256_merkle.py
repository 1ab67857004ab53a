"""SHA-256 Merkle hasher (framework-defined semantics).

Fills the role of the reference's `Sha256MerkleHasher` /
`Sha256Poseidon31MerkleHasher` tree hashing (used for the penultimate and
final chain levels, examples/multi-proofs/src/main.rs:289-295 and
examples/last-layer/src/main.rs:194).  The stwo fork's exact byte-level
semantics are not recoverable (docs/sha256_channel_notes.md), so this
module defines the framework's own, fully specified, self-consistent
rules; digests are stored as 8 big-endian uint32 words (same container
shape as Poseidon31 digests, so every decommitment/path structure is
shared between flavors):

  leaf  (max-log level):  sha256(col_0 || col_1 || ... )
  inner (no columns):     sha256(left_digest || right_digest)
  inner (with columns):   sha256(left || right || col_0 || ...)

where each column value is one big-endian u32 word and digests are their
32 bytes.  `hash_node` is call-compatible with
verifier/hints.hash_node (the Poseidon31 flavor) so the path-expansion
machinery takes it as `hash_node_fn`.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..core.sha256 import sha256_words


def hash_node(children, cols: np.ndarray) -> np.ndarray:
    """Scalar node hash; signature-compatible with hints.hash_node."""
    cols = np.asarray(cols, np.uint32).reshape(-1)
    if children is None:
        words = cols
    else:
        left, right = children
        words = np.concatenate(
            [np.asarray(left, np.uint32), np.asarray(right, np.uint32), cols]
        )
    nat = _native()
    if nat is not None:
        return nat.sha256_words_batch(words[None, :])[0]
    return sha256_words(words[None, :])[0]


def _native():
    from ..utils import native

    return native if native.sha_available() else None


def hash_leaf_level(columns: np.ndarray) -> np.ndarray:
    """(n_cols, N) -> (N, 8) leaf digests, vectorized over N."""
    nat = _native()
    if nat is not None and columns.shape[1] >= 64:
        return nat.sha256_leaf_level(columns)
    return sha256_words(np.ascontiguousarray(columns.T))


def hash_node_level(
    children: np.ndarray, columns: np.ndarray | None
) -> np.ndarray:
    """children (2N, 8) -> (N, 8); columns (n_cols, N) absorbed if given."""
    nat = _native()
    if nat is not None and children.shape[0] >= 128:
        return nat.sha256_node_level(children, columns)
    N = children.shape[0] // 2
    pairs = children.reshape(N, 16)
    if columns is not None and columns.shape[0]:
        pairs = np.concatenate([pairs, columns.T], axis=1)
    return sha256_words(np.ascontiguousarray(pairs))


def merkle_levels(columns_by_log: Dict[int, np.ndarray]) -> List[np.ndarray]:
    """Full tree levels (index 0 = leaves) for mixed-size column sets."""
    max_log = max(columns_by_log)
    levels = [hash_leaf_level(columns_by_log[max_log])]
    h = levels[0]
    for L in range(max_log - 1, -1, -1):
        h = hash_node_level(h, columns_by_log.get(L))
        levels.append(h)
    return levels
