"""ctypes wrappers of the SHA-256 tree-level kernel (csrc/sha256.cu) and the
SHA-256 channel's proof-of-work grind (csrc/sha256_grind.cu).

  sha256_level(children, cols) -> (n, 8) int64 digest words in [0, 2**32):
      one level of n nodes of a SHA-256 Merkle tree under the rules of
      verifier/sha256_merkle.py: a leaf hashes its row of the (n_cols, n)
      columns (children None), a node its two children of the (2n, 8) level
      below, then the row's columns if any.  The twin of what XLA compiled
      from recursive_stwo_tpu/core/sha256.py `_compress_traced` /
      `sha256_words` for the JAX package's streamed prover
      (prover/stream.py:278-298).

It takes CUDA int64 tensors (M31 residues and digest words in [0, 2**32))
and raises on anything else; the plain version is
core/sha256.sha256_level_plain.  The output is int64, so a level feeds the
next one as it stands; a caller that copies digests to the host as int32
reads them back with `.view(numpy.uint32)`, never sign-extended.  The
column tensor may be a column slice of a larger one (its rows any stride,
its entries contiguous), so a span of a resident block is hashed in place.
A kernel launches on the current stream of its tensors' device and does
not synchronise.

  sha256_grind(digest_words, pow_bits, start, device) -> int: the smallest
      nonce n >= start whose mix leaves `pow_bits` trailing zero bits
      (prover/prove_sha256.py `Sha256ProverChannel.grind_pow`), the nonce
      native/sha256.cpp's host scan returns: one launch on the device's
      current stream and one 8-byte read of the result, which waits for it.

`LAUNCHES` counts each kernel's launches.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build, poseidon_cuda
from .poseidon_cuda import H100_BYTES_PER_S, H100_INT_OPS_PER_S, _raise_on

LAUNCHES = {"sha256_level": 0, "sha256_grind": 0}

# int32 operations of one compression as csrc/sha256.cu writes it: 48
# schedule steps (two sigmas of two rotations, a shift and two xors, and
# three adds: 13), 64 rounds (two Sigmas at 5, ch 4, maj 5, seven adds: 26)
# and the 8 adds into the state
INT_OPS_PER_COMPRESSION = 48 * 13 + 64 * 26 + 8

# int32 operations of one nonce as csrc/sha256_grind.cu writes it, counted
# as INT_OPS_PER_COMPRESSION counts them, less what folds away: the two
# bswapped nonce words (2); the first block's 48 schedule steps and 64
# rounds with the zero words folded and the digest-only terms hoisted (2,156)
# and its 8 adds into the state; the padding block's 63 rounds on constant
# K + W (25 each), and its last round's `a` with word 0's add into the state
# (25); the hit test's bswap and mask (2).  tests/test_torch_sha256_grind.py
# replays the kernel to count it.
GRIND_INT_OPS_PER_NONCE = 2 + 2_156 + 8 + 63 * 25 + 25 + 2


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def compressions(n: int, n_words: int) -> int:
    """Compressions of n messages of n_words words each."""
    return n * ((n_words + 3 + 15) // 16)


def bound_ms(n: int, n_cols: int, with_children: bool) -> tuple:
    """(milliseconds, "operations" or "bytes"): the larger of the two floors
    for a level of n nodes, at the int32 rate ops/poseidon_cuda uses (132
    SMs x 128 lanes x 1.98 GHz; an SM has 64 INT32 lanes, so this floor is
    half what the card could reach) and 3.35 TB/s for the int64 words read
    once (16 child words, n_cols column entries a node) and written once (8)."""
    n_words = (16 if with_children else 0) + n_cols
    ops = compressions(n, n_words) * INT_OPS_PER_COMPRESSION / H100_INT_OPS_PER_S
    mem = n * (n_words + 8) * 8 / H100_BYTES_PER_S
    return (ops * 1e3, "operations") if ops >= mem else (mem * 1e3, "bytes")


def _check(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor for {name}, got one on {x.device}")
    if x.dtype != torch.int64:
        raise TypeError(f"expected torch.int64 for {name}, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"expected a 2-D tensor for {name}, got {tuple(x.shape)}")


def sha256_level(children, cols) -> torch.Tensor:
    """One SHA-256 tree level on the card: children (2n, 8) or None, cols
    (n_cols, n) or None; at least one of them."""
    if children is None and cols is None:
        raise ValueError("a tree level needs children, columns or both")
    ref = children if children is not None else cols
    if children is not None:
        _check(children, "children")
        if children.shape[1] != 8 or children.shape[0] % 2 or not children.is_contiguous():
            raise ValueError(f"expected contiguous (2n, 8) children, got {tuple(children.shape)}")
        n = children.shape[0] // 2
    else:
        n = cols.shape[1]
    if cols is not None and cols.shape[0] == 0:
        cols = None
    if cols is not None:
        _check(cols, "cols")
        if cols.device != ref.device:
            raise ValueError(f"children on {ref.device}, columns on {cols.device}")
        if cols.shape[1] != n:
            raise ValueError(f"expected {n} column entries a row, got {cols.shape[1]}")
        if n > 1 and cols.stride(1) != 1:
            raise ValueError("expected the columns' entries contiguous (stride 1 along a row)")
    out = torch.empty((n, 8), dtype=torch.int64, device=ref.device)
    lib = build.load()
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream(ref.device).cuda_stream
        err = lib.sha256_level(
            None if children is None else children.data_ptr(),
            None if cols is None else cols.data_ptr(),
            0 if cols is None else cols.stride(0),
            0 if cols is None else cols.shape[0],
            n, out.data_ptr(), stream,
        )
    _raise_on(err, "sha256_level")
    if n:
        LAUNCHES["sha256_level"] += 1
    return out


def grind_bound_ms(nonces: int) -> float:
    """The least time of `nonces` nonces of the grind at GRIND_INT_OPS_PER_NONCE,
    at the int32 rate bound_ms uses; the grind reads and writes nothing a
    nonce."""
    return nonces * GRIND_INT_OPS_PER_NONCE / H100_INT_OPS_PER_S * 1e3


def sha256_grind(digest_words, pow_bits: int, start: int = 0, device="cuda") -> int:
    """The smallest nonce n >= start whose mix, sha256(le8(n) || 24 zero
    bytes || digest), leaves `pow_bits` trailing zero bits in the
    little-endian reading of the new digest's first word.  digest_words: the
    channel digest's 8 big-endian words; 1 <= pow_bits <= 32; 0 <= start <
    2**64; device: a CUDA device.  Nonces up to 2**64 - 2 are scanned; raises
    if none of them hits."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the grind kernel runs on a CUDA device, got {device}")
    if not 1 <= pow_bits <= 32:
        raise ValueError(f"pow_bits {pow_bits} outside [1, 32]")
    words = [int(w) for w in np.asarray(digest_words).reshape(-1)]
    if len(words) != 8 or not all(0 <= w < 2**32 for w in words):
        raise ValueError(f"expected a digest of 8 words in [0, 2**32), got {words}")
    if not 0 <= start < 2**64:
        raise ValueError(f"start {start} outside [0, 2**64)")
    return poseidon_cuda.grind(LAUNCHES, "sha256_grind", "sha256_grind", words, pow_bits, start, device)
