"""Merkle commitment over mixed-size columns, on the device.

Twin of device_prove.py:49-146 (`_absorb_columns`, `_commit_levels`,
`_merge_t`, `DeviceTree`).  Hash semantics are commit._hash_leaf_level /
_hash_node_level's.  A level is one call of `_level`: on CUDA one launch of
the Merkle level kernel (ops/merkle_cuda.py), which reads the columns in
place and keeps each node's state in registers across every 8-column chunk;
on the CPU the plain version, `level_plain`, which permutes (n, 16) rows of
8 column words beside 8 digest words, or two child digests side by side
(`core/poseidon2.permute`).

`Sha256DeviceTree` is the twin of commit.py:178-188 `Sha256CommittedTree`:
its columns stay on the device, as the quotient stage reads them there, and
its levels are hashed there too, by `core/sha256.sha256_level` (the SHA-256
tree-level kernel on CUDA, its plain version on the CPU); only each level's
digests are copied to the host.

Every tree built is one `tree.commit` span (utils/spans.py); a SHA-256
level of a block is one `sha256.level` span, the copy of its digests one
`to_host` span after it.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..core import poseidon2
from ..core.sha256 import sha256_level
from ..ops import merkle_cuda
from ..utils.spans import span
from ..verifier import sha256_merkle
from .arrays import to_numpy
from .commit_host import CommittedTree, _hash_node_level

# leaf rows of a SHA-256 tree hashed as one block, down through every level
# the block covers: a block's digests on the device are (SHA_ROWS, 8) int64
# (256 MiB), where a whole 2**27-leaf level would be 8 GiB
SHA_ROWS = 1 << 22


def absorb_columns(cols: torch.Tensor) -> torch.Tensor:
    """(n_cols, n) M31 columns -> (n, 8) running digests, 8 columns a step."""
    n_cols, n = cols.shape
    digest = torch.zeros((n, 8), dtype=torch.int64, device=cols.device)
    for ci in range(0, n_cols, 8):
        chunk = cols[ci : ci + 8].T
        chunk = torch.nn.functional.pad(chunk, (0, 8 - chunk.shape[1]))
        digest = poseidon2.permute(torch.cat([chunk, digest], dim=1))[:, 8:]
    return digest


def level_plain(children, cols, n: int) -> torch.Tensor:
    """One tree level of n nodes: the leaf level (children None) absorbs its
    columns and hashes [0; digest]; a node level hashes its child pairs,
    then [h; digest] if columns of this size are merged in."""
    if children is None:
        digest = absorb_columns(cols)
        return poseidon2.permute(torch.cat([torch.zeros_like(digest), digest], dim=1))[:, :8]
    h = poseidon2.permute(children.reshape(n, 16))[:, :8]
    if cols is not None and cols.shape[0]:
        h = poseidon2.permute(torch.cat([h, absorb_columns(cols)], dim=1))[:, :8]
    return h


def _level(children, cols, n: int) -> torch.Tensor:
    """`level_plain`'s level: on CUDA one launch of the Merkle level kernel,
    on the CPU the plain version."""
    if (cols if children is None else children).device.type == "cpu":
        return level_plain(children, cols, n)
    return merkle_cuda.level(children, cols, n)


def commit_levels(cols_by_log: Dict[int, torch.Tensor]) -> List[torch.Tensor]:
    """Every tree level as an (2**L, 8) tensor, leaf level first."""
    max_log = max(cols_by_log)
    levels = [_level(None, cols_by_log[max_log], 1 << max_log)]
    for L in range(max_log - 1, -1, -1):
        levels.append(_level(levels[-1], cols_by_log.get(L), 1 << L))
    return levels


def sha256_levels(cols_by_log: Dict[int, torch.Tensor]) -> List[np.ndarray]:
    """Every level of the SHA-256 tree (`sha256_merkle.merkle_levels`) as
    (2**L, 8) uint32 big-endian words on the host, leaf level first, hashed
    where the columns lie.  An aligned block of SHA_ROWS leaf rows fixes
    every node above it down to one digest, since a node depends only on its
    children and its own column entries: each block is hashed down to that
    digest, level by level, then the blocks' digests up to the root.  Each
    level's digests are copied into its host array as int32 bit patterns
    (the kernel writes int64 words in [0, 2**32)), which the array reads as
    uint32."""
    max_log = max(cols_by_log)
    levels = [np.empty((1 << L, 8), np.uint32) for L in range(max_log, -1, -1)]

    def level(children, L: int, lo: int, hi: int) -> torch.Tensor:
        cols = cols_by_log.get(L)
        with span("sha256.level"):
            h = sha256_level(children, None if cols is None else cols[:, lo:hi])
        # straight into the level's host array: no host tensor in between
        with span("to_host"):
            torch.from_numpy(levels[max_log - L][lo:hi].view(np.int32)).copy_(h.to(torch.int32))
        return h

    block_log = min(max_log, SHA_ROWS.bit_length() - 1)
    top = max_log - block_log  # the level where each block ends in one digest
    summits = []
    for s in range(0, 1 << max_log, 1 << block_log):
        h = None
        for L in range(max_log, top - 1, -1):
            shift = max_log - L
            h = level(h, L, s >> shift, (s >> shift) + (1 << (block_log - shift)))
        summits.append(h)
    h = torch.cat(summits) if len(summits) > 1 else summits[0]
    for L in range(top - 1, -1, -1):
        h = level(h, L, 0, 1 << L)
    return levels


def merge_by_log(pairs) -> Dict[int, torch.Tensor]:
    """Concatenate same-log column groups in call order (`_merge_t`)."""
    out: Dict[int, list] = {}
    for log, cols in pairs:
        out.setdefault(log, []).append(cols)
    return {log: parts[0] if len(parts) == 1 else torch.cat(parts) for log, parts in out.items()}


class DeviceTree(CommittedTree):
    """CommittedTree whose columns and levels stay on the device; the
    decommit plans are the base class's, and only the rows they name are
    copied to the host.  The class decides the hash: `device_level` and
    `host_node_level` are one level of it on the device and one node level
    on the host, as a StreamedTree of this class hashes them."""

    host_node_level = staticmethod(_hash_node_level)

    @staticmethod
    def device_level(children, cols) -> torch.Tensor:
        """The leaf level when `children` is None, else a node level."""
        return _level(children, cols, cols.shape[1] if children is None else children.shape[0] // 2)

    def __init__(self, columns_by_log: Dict[int, torch.Tensor]):
        self.columns_by_log = {int(L): c for L, c in columns_by_log.items()}
        self.max_log = max(self.columns_by_log)
        with span("tree.commit"):
            self.levels = self._build_levels()
        if self.levels[-1].shape[0] != 1:
            raise ValueError("the last level must hold the root alone")

    def _build_levels(self):
        return commit_levels(self.columns_by_log)

    @property
    def root(self) -> np.ndarray:
        return to_numpy(self.levels[-1][0])

    def _index(self, indices, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(np.asarray(indices, np.int64), device=like.device)

    def level_rows(self, level_idx: int, indices) -> np.ndarray:
        level = self.levels[level_idx]
        return to_numpy(level[self._index(indices, level)])

    def column_rows(self, log_size: int, indices) -> np.ndarray:
        cols = self.columns_by_log[log_size]
        return to_numpy(cols[:, self._index(indices, cols)])


class Sha256DeviceTree(DeviceTree):
    """The SHA-256 flavour: columns on the device, hashed there, and levels
    of uint32 digest words on the host (a 2**26-leaf tree's levels take
    4 GiB there)."""

    device_level = staticmethod(sha256_level)
    host_node_level = staticmethod(sha256_merkle.hash_node_level)

    def _build_levels(self):
        return sha256_levels(self.columns_by_log)

    @property
    def root(self) -> np.ndarray:
        return self.levels[-1][0].copy()

    def level_rows(self, level_idx: int, indices) -> np.ndarray:
        return self.levels[level_idx][np.asarray(indices, np.int64)]
