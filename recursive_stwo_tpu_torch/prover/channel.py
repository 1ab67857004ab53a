"""Poseidon31 Fiat-Shamir channel of the prover, with the PoW grind on the card.

`PoseidonChannel` is the host channel (channel_host.py, a copy of
recursive_stwo_tpu/prover/channel.py:73-149) with `grind_pow` on a CUDA
device, at any bits, one launch of the grind kernel
(ops/poseidon_cuda.py `p31_grind`, csrc/poseidon2_grind.cu); on the CPU, and
at 0 bits, the host native scan.

`grind_device` is the kernel's plain version, the twin of the JAX package's
`_grind_batch_jit` / `grind_device` (:20-70), which the tests hold the kernel to.
A nonce n is absorbed as the limbs (n mod 2**22, n >> 22 mod 2**21,
n >> 43 mod 2**21).  Blocks of 2**block_log nonces (block_log <= 22) start
at multiples of their size, so inside a block only limb 0 moves, by the
block's iota: each block's states are built on the device from the iota and
two scalar limbs, permuted by K1, and the first hit in the block is the
smallest nonce overall.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import poseidon2
from ..ops import poseidon_cuda
from ..utils import native
from ..utils.spans import span
from .channel_host import PoseidonChannel as HostPoseidonChannel

_LIMB0 = 22
_LIMB = 21


def grind_device(digest, pow_bits: int, block_log: int = 22, device="cuda") -> int:
    """Smallest nonce whose absorption leaves digest word 0 with `pow_bits`
    low zero bits.  `block_log` is the nonces per permutation batch (small
    in the CPU tests)."""
    if not 0 <= block_log <= _LIMB0:
        raise ValueError(f"block_log {block_log} outside [0, {_LIMB0}]")
    device = torch.device(device)
    n = 1 << block_log
    mask = (1 << pow_bits) - 1
    iota = torch.arange(n, dtype=torch.int64, device=device)
    tail = torch.as_tensor(np.asarray(digest, np.int64), device=device)
    base = 0
    while True:
        states = torch.zeros((n, 16), dtype=torch.int64, device=device)
        states[:, 0] = iota + (base & ((1 << _LIMB0) - 1))
        states[:, 1] = (base >> _LIMB0) & ((1 << _LIMB) - 1)
        states[:, 2] = (base >> (_LIMB0 + _LIMB)) & ((1 << _LIMB) - 1)
        states[:, 8:] = tail
        # nonzero reads the hits' count back to the host: the block's check
        with span("to_host"):
            hits = torch.nonzero((poseidon2.permute(states)[:, 8] & mask) == 0)
        if hits.numel():
            with span("to_host"):
                return base + int(hits[0, 0])
        base += n


def grind_host(digest, pow_bits: int) -> int:
    """The host native scan (utils/native.py `grind`): a prover's grind on
    the CPU."""
    if not native.available():
        raise RuntimeError("the host PoW scan needs the native library (utils/native.py)")
    return native.grind(np.asarray(digest, np.uint32), pow_bits)


class PoseidonChannel(HostPoseidonChannel):
    def __init__(self, device):
        super().__init__()
        self.device = torch.device(device)

    def grind_pow(self, pow_bits: int) -> int:
        if pow_bits and self.device.type == "cuda":
            return poseidon_cuda.p31_grind(self.digest, pow_bits, device=self.device)
        return grind_host(self.digest, pow_bits)
