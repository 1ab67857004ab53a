"""Host copy of recursive_stwo_tpu/prover/channel.py (numpy only; its jax branches are
removed).  The torch twin is channel.py beside it.

Interactive Poseidon31 Fiat-Shamir channel (prover side).

Bit-exact with the verifier's scan-based transcript replay
(verifier/transcript.py: digest = capacity(permute(op || digest)), draws
put the send counter in the rate and never touch the digest) — which is in
turn fixture-validated against stwo.
"""

from __future__ import annotations

import numpy as np

from ..core import poseidon2_host as poseidon2


class PoseidonChannel:
    def __init__(self):
        self.digest = np.zeros(8, np.uint32)
        self.n_sent = 0

    def _absorb(self, op8: np.ndarray) -> None:
        state = np.concatenate([op8.astype(np.uint32), self.digest])
        self.digest = poseidon2.permute(state)[8:]
        self.n_sent = 0

    def mix_root(self, root8) -> None:
        self._absorb(np.asarray(root8, np.uint32))

    def mix_one_felt(self, felt4) -> None:
        op = np.zeros(8, np.uint32)
        op[0:4] = np.asarray(felt4, np.uint32)
        self._absorb(op)

    def mix_two_felts(self, felt1, felt2) -> None:
        op = np.concatenate(
            [np.asarray(felt1, np.uint32), np.asarray(felt2, np.uint32)]
        )
        self._absorb(op)

    def mix_u64(self, nonce: int) -> None:
        op = np.zeros(8, np.uint32)
        op[0] = nonce & ((1 << 22) - 1)
        op[1] = (nonce >> 22) & ((1 << 21) - 1)
        op[2] = (nonce >> 43) & ((1 << 21) - 1)
        self._absorb(op)

    def draw_felts(self):
        """Two QM31 draws as (4,) uint32 arrays; digest unchanged."""
        left = np.zeros(8, np.uint32)
        left[0] = self.n_sent
        self.n_sent += 1
        rate = poseidon2.permute(np.concatenate([left, self.digest]))[:8]
        return rate[0:4], rate[4:8]

    def draw_felt(self):
        return self.draw_felts()[0]

    def grind_pow(self, pow_bits: int, batch: int = 1 << 12) -> int:
        """Find a nonce whose mix leaves digest limb0 with `pow_bits` low
        zero bits: the AVX-512 16-way native scan, else vectorized numpy
        batches (the port's prover/channel.py grinds on the card)."""
        from ..utils import native

        if native.available():
            return native.grind(self.digest, pow_bits)
        mask = np.uint32((1 << pow_bits) - 1)
        base = 0
        while True:
            nonces = np.arange(base, base + batch, dtype=np.uint64)
            ops = np.zeros((batch, 16), np.uint32)
            ops[:, 0] = (nonces & ((1 << 22) - 1)).astype(np.uint32)
            ops[:, 1] = ((nonces >> np.uint64(22)) & ((1 << 21) - 1)).astype(
                np.uint32
            )
            ops[:, 2] = ((nonces >> np.uint64(43)) & ((1 << 21) - 1)).astype(
                np.uint32
            )
            ops[:, 8:] = self.digest
            digests = poseidon2.permute(ops)[:, 8:]
            hits = np.nonzero((digests[:, 0] & mask) == 0)[0]
            if hits.size:
                return int(nonces[hits[0]])
            base += batch
