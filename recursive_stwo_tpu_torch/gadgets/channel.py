"""In-circuit Poseidon31 Fiat-Shamir channel.

Digest = capacity half of the sponge; draws put a send-counter in the rate
half and never touch the digest.  Mirrors
/root/reference/primitives/channel/src/lib.rs (semantics identical to the
native transcript replay in verifier/transcript.py).
"""

from __future__ import annotations

from .fields import M31Var, QM31Var
from .poseidon import Poseidon2Half


class ChannelVar:
    __slots__ = ("n_sent", "digest")

    def __init__(self, cs):
        self.n_sent = 0
        self.digest = Poseidon2Half.zero(cs)

    @property
    def cs(self):
        return self.digest.cs

    def mix_root(self, root: Poseidon2Half) -> None:
        self.digest = Poseidon2Half.permute_get_capacity(root, self.digest)
        self.n_sent = 0

    def draw_felts(self):
        cs = self.cs
        n_sent = M31Var.new_constant(cs, self.n_sent)
        self.n_sent += 1
        left = Poseidon2Half.from_qm31(
            QM31Var.from_m31var(n_sent), QM31Var.zero(cs)
        )
        return Poseidon2Half.permute_get_rate(left, self.digest).to_qm31()

    def mix_one_felt(self, felt: QM31Var) -> None:
        cs = self.cs
        left = Poseidon2Half.from_qm31(felt, QM31Var.zero(cs))
        self.digest = Poseidon2Half.permute_get_capacity(left, self.digest)
        self.n_sent = 0

    def mix_two_felts(self, felt1: QM31Var, felt2: QM31Var) -> None:
        left = Poseidon2Half.from_qm31(felt1, felt2)
        self.digest = Poseidon2Half.permute_get_capacity(left, self.digest)
        self.n_sent = 0
