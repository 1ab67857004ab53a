"""Vectorized SHA-256 over numpy uint32 word arrays.

Used by the framework's SHA-256 Merkle/channel flavors (the reference's
`Sha256MerkleChannel` / `Sha256Poseidon31MerkleChannel` output and
penultimate chain levels, examples/multi-proofs/src/main.rs:289-295 and
examples/last-layer/src/main.rs:194).  The stwo fork's exact byte-level
semantics are not recoverable (external git dep, not vendored; see
docs/sha256_channel_notes.md), so the framework defines its own fully
specified SHA-256 channel + hasher and is self-consistent end-to-end
(prove and verify under the same definitions).

Messages are sequences of uint32 words interpreted big-endian (so a
digest stored as 8 uint32 words round-trips through hashlib.sha256 via
`bytes -> np.frombuffer(d, '>u4')`).  `sha256_words` is vectorized over
the leading axis: hashing 2^24 Merkle nodes is ~128 rounds of elementwise
uint32 ops over the batch.

Host copy of recursive_stwo_tpu/core/sha256.py (numpy: `compress`,
`sha256_words` and the byte helpers), with its traced branches (`_xp`, and
`_compress_traced`, the `lax.scan` form of `compress`) replaced by a torch
twin on int64 tensors of words in [0, 2**32): `compress_plain`,
`sha256_words_plain` and `sha256_level_plain`, the plain PyTorch version of
one Merkle tree level under the rules of verifier/sha256_merkle.py.
`sha256_level` dispatches on the tensors' device: a CPU tensor takes the
plain version, a CUDA tensor launches the hand-written kernel
(ops/sha256_cuda.py, csrc/sha256.cu) or raises.  The JAX package reaches
`_compress_traced` only from its streamed prover's SHA-256 commits
(prover/stream.py:278-298); the port's streamed prover and its resident
`Sha256DeviceTree` hash every level through `sha256_level`.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

_K = np.array([
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
], np.uint32)

_H0 = np.array([
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
], np.uint32)


def _rotr(x: np.ndarray, n: int) -> np.ndarray:
    return (x >> np.uint32(n)) | (x << np.uint32(32 - n))


def compress(state: np.ndarray, block: np.ndarray) -> np.ndarray:
    """state (N, 8) x block (N, 16) -> (N, 8), all uint32.

    Pure uint32 rotate/add/xor; the 64 rounds are unrolled (a python loop
    over vectorized ops)."""
    w = [block[:, i] for i in range(16)]
    for i in range(16, 64):
        s0 = _rotr(w[i - 15], 7) ^ _rotr(w[i - 15], 18) ^ (w[i - 15] >> np.uint32(3))
        s1 = _rotr(w[i - 2], 17) ^ _rotr(w[i - 2], 19) ^ (w[i - 2] >> np.uint32(10))
        w.append(w[i - 16] + s0 + w[i - 7] + s1)
    a, b, c, d, e, f, g, h = (state[:, i] for i in range(8))
    for i in range(64):
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = h + S1 + ch + _K[i] + w[i]
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = S0 + maj
        h, g, f, e, d, c, b, a = g, f, e, d + t1, c, b, a, t1 + t2
    return state + np.stack([a, b, c, d, e, f, g, h], axis=1)


def sha256_words(words: np.ndarray) -> np.ndarray:
    """(N, K) uint32 big-endian words -> (N, 8) uint32 digests.

    Equivalent to hashlib.sha256 over the 4K-byte big-endian encoding."""
    words = np.atleast_2d(np.asarray(words, np.uint32))
    N, K = words.shape
    bitlen = 32 * K
    # message + 0x80000000 word + zero pad + 2 length words
    n_blocks = (K + 3 + 15) // 16
    pad = np.zeros((N, 16 * n_blocks - K), np.uint32)
    padded = np.concatenate([words, pad], axis=1)
    padded[:, K] = 0x80000000
    padded[:, -2] = bitlen >> 32
    padded[:, -1] = bitlen & 0xFFFFFFFF
    state = np.broadcast_to(_H0, (N, 8)).copy()
    for bi in range(n_blocks):
        state = compress(state, padded[:, 16 * bi : 16 * bi + 16])
    return state


def digest_to_words(digest32: bytes) -> np.ndarray:
    """hashlib 32-byte digest -> (8,) uint32 big-endian words."""
    return np.frombuffer(digest32, ">u4").astype(np.uint32)


def words_to_bytes(words8) -> bytes:
    return np.asarray(words8, np.uint32).astype(">u4").tobytes()


def sha256_words_scalar(words) -> np.ndarray:
    """Reference path via hashlib (testing / host scalar transcripts)."""
    return digest_to_words(hashlib.sha256(words_to_bytes(words)).digest())


# ---------------------------------------------------------------------------
# torch twin: int64 tensors holding uint32 words
# ---------------------------------------------------------------------------

MASK = 0xFFFFFFFF


def _doubled(x: torch.Tensor) -> torch.Tensor:
    """x | x << 32: bits n..n+31 of it are rotr(x, n) for 0 <= n < 32.  The
    left shift wraps into the sign bit; an arithmetic >> n then fills bits
    64-n and up, which the mask after it drops."""
    return x | (x << 32)


def compress_plain(state: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """state (N, 8) x block (N, 16) -> (N, 8): `compress` on int64 tensors
    of uint32 words.  Each rotation is a shift of the doubled word; the
    three rotations of a Sigma share one mask, a sum of at most five words
    (< 2**35, exact in int64) is masked to 32 bits once, and ch is written
    g ^ (e & (f ^ g)), maj (a & b) | (c & (a | b)), with no complement (~ of
    a non-negative int64 is negative).  About 3,000 eager ops a
    compression, against 4,200 for the word-for-word form."""
    w = list(block.unbind(1))
    for i in range(16, 64):
        a, b = w[i - 15], w[i - 2]
        da, db = _doubled(a), _doubled(b)
        s0 = ((da >> 7) ^ (da >> 18)) & MASK ^ (a >> 3)
        s1 = ((db >> 17) ^ (db >> 19)) & MASK ^ (b >> 10)
        w.append((w[i - 16] + s0 + w[i - 7] + s1) & MASK)
    a, b, c, d, e, f, g, h = state.unbind(1)
    for i in range(64):
        de = _doubled(e)
        s1 = ((de >> 6) ^ (de >> 11) ^ (de >> 25)) & MASK
        t1 = h + s1 + (g ^ (e & (f ^ g))) + (w[i] + int(_K[i]))
        da = _doubled(a)
        s0 = ((da >> 2) ^ (da >> 13) ^ (da >> 22)) & MASK
        maj = (a & b) | (c & (a | b))
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & MASK, c, b, a, (t1 + s0 + maj) & MASK
    return (state + torch.stack([a, b, c, d, e, f, g, h], dim=1)) & MASK


def sha256_words_plain(words: torch.Tensor) -> torch.Tensor:
    """(N, K) int64 big-endian words -> (N, 8) digest words: `sha256_words`
    on tensors (the message, the word 0x80000000, zeros, and the 64-bit bit
    length as two words, in (K + 3 + 15) // 16 blocks)."""
    n, k = words.shape
    n_blocks = (k + 3 + 15) // 16
    padded = torch.zeros((n, 16 * n_blocks), dtype=torch.int64, device=words.device)
    padded[:, :k] = words
    padded[:, k] = 0x80000000
    padded[:, -2] = (32 * k) >> 32
    padded[:, -1] = (32 * k) & MASK
    state = torch.as_tensor(_H0.astype(np.int64), device=words.device).expand(n, 8)
    for bi in range(n_blocks):
        state = compress_plain(state, padded[:, 16 * bi : 16 * bi + 16])
    return state


def _level_size(children, cols) -> int:
    if children is not None:
        return children.shape[0] // 2
    if cols is None:
        raise ValueError("a tree level needs children, columns or both")
    return cols.shape[1]


def sha256_level_plain(children, cols) -> torch.Tensor:
    """One level of n nodes of a SHA-256 Merkle tree: a leaf (children None)
    hashes its row of the (n_cols, n) columns; a node hashes its two
    children of the (2n, 8) level below, then the row's columns if `cols`
    is given and has any."""
    n = _level_size(children, cols)
    parts = [] if children is None else [children.reshape(n, 16)]
    if cols is not None and cols.shape[0]:
        parts.append(cols.T)
    return sha256_words_plain(torch.cat(parts, dim=1) if len(parts) > 1 else parts[0])


def sha256_level(children, cols) -> torch.Tensor:
    """One SHA-256 tree level (`sha256_level_plain`'s rules) on the tensors'
    device: the plain version on the CPU, the kernel on CUDA.  Returns
    (n, 8) int64 digest words in [0, 2**32)."""
    ref = cols if children is None else children
    if ref.device.type == "cpu":
        return sha256_level_plain(children, cols)
    from ..ops import sha256_cuda

    return sha256_cuda.sha256_level(children, cols)
