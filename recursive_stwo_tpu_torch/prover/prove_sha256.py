"""Sha256Poseidon31-flavor prover: the with-poseidon AIR proved under a
SHA-256 Fiat-Shamir channel with SHA-256 Merkle trees.

Mirrors the reference's penultimate chain level
(`demo_recurse::<Sha256Poseidon31MerkleChannel>`,
examples/multi-proofs/src/main.rs:289-295) whose output feeds the
last-layer example.  The stwo fork's exact SHA-256 byte conventions are
not recoverable (docs/sha256_channel_notes.md); this flavor uses the
framework's own fully specified channel (verifier/sha256_channel.py,
confirmed-prefix semantics) + tree rules (verifier/sha256_merkle.py) and
is verified end-to-end by verifier/verify_sha256.py.

Copied from recursive_stwo_tpu/prover/prove_sha256.py: `Sha256ProverChannel`,
which the SHA-256 transcripts of the verifiers replay, with `grind_pow` on
the prover's device (prove.flavour sets it): on a CUDA device one launch of
the grind kernel (ops/sha256_cuda.py `sha256_grind`), on the host the native
scan.  Both return the smallest nonce, so the proof is the same.
`prove_sha256p31` is the port's `prove` with this channel and
`Sha256DeviceTree` on `device`.
"""

from __future__ import annotations

import numpy as np

from ..core.sha256 import _H0, compress
from ..ops import sha256_cuda
from ..proof.containers import PcsConfig, PlonkWithPoseidonProof
from ..verifier.sha256_channel import Sha256Channel


class Sha256ProverChannel:
    """Adapter giving verifier/sha256_channel.Sha256Channel the prover
    channel interface (PoseidonChannel parity: mix_root takes an (8,)
    uint32 word digest; draws return (4,) uint32 felts).  `device` is where
    the grind runs: the host until a prover sets its own (prove.flavour)."""

    def __init__(self):
        self.ch = Sha256Channel()
        self.device = None

    # -- mixing -------------------------------------------------------------

    def mix_root(self, root8) -> None:
        self.ch.mix_root(
            np.asarray(root8, np.uint32).astype(">u4").tobytes()
        )

    def mix_one_felt(self, felt4) -> None:
        self.ch.mix_felts([tuple(int(x) for x in felt4)])

    def mix_two_felts(self, felt1, felt2) -> None:
        self.ch.mix_felts(
            [tuple(int(x) for x in felt1), tuple(int(x) for x in felt2)]
        )

    def mix_u64(self, nonce: int) -> None:
        self.ch.mix_u64(int(nonce))

    # -- drawing ------------------------------------------------------------

    def draw_felts(self):
        a, b = self.ch.draw_felts(2)
        return np.array(a, np.uint32), np.array(b, np.uint32)

    def draw_felt(self):
        return np.array(self.ch.draw_felt(), np.uint32)

    # -- proof of work --------------------------------------------------------

    def grind_pow(self, pow_bits: int, batch: int = 1 << 16) -> int:
        """Find a nonce whose mix leaves `pow_bits` trailing zero bits in
        the digest (LE interpretation, Sha256Channel.trailing_zeros).

        One mix_u64 = sha256 of a 64-byte message (le8(nonce) + 24 zero
        bytes || digest) = 2 compressions.  On the card when `device` is a
        CUDA device; else the native AVX-512 16-way scan when available
        (~50M nonces/s), else numpy in batches.  At 0 bits every nonce
        passes and the host returns the first."""
        digest_words = np.frombuffer(self.ch.digest, ">u4").astype(np.uint32)
        if pow_bits and self.device is not None and self.device.type == "cuda":
            return sha256_cuda.sha256_grind(digest_words, pow_bits, device=self.device)
        from ..utils import native

        if native.sha_available():
            return native.sha256_grind(digest_words, pow_bits)
        mask = np.uint32((1 << pow_bits) - 1)
        pad = np.zeros((batch, 16), np.uint32)
        pad[:, 0] = 0x80000000
        pad[:, 15] = 512
        h0 = np.broadcast_to(_H0, (batch, 8)).copy()
        base = 0
        while True:
            nonces = np.arange(base, base + batch, dtype=np.uint64)
            block = np.zeros((batch, 16), np.uint32)
            block[:, 0] = (nonces & np.uint64(0xFFFFFFFF)).astype(np.uint32).byteswap()
            block[:, 1] = (nonces >> np.uint64(32)).astype(np.uint32).byteswap()
            block[:, 8:] = digest_words
            state = compress(compress(h0, block), pad)
            first_le = state[:, 0].byteswap()
            hits = np.nonzero((first_le & mask) == 0)[0]
            if hits.size:
                return int(nonces[hits[0]])
            base += batch


def prove_sha256p31(
    trace: dict, config: PcsConfig, progress=None, device="cuda"
) -> PlonkWithPoseidonProof:
    # prove.py routes on this module's channel class: import it here
    from .commit import Sha256DeviceTree
    from .prove import prove

    return prove(
        trace,
        config,
        progress,
        device,
        channel=Sha256ProverChannel(),
        tree_cls=Sha256DeviceTree,
    )
