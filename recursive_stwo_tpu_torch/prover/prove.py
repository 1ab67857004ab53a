"""The port's prover entry point, and the flavours of every prover.

Twin of the routing in recursive_stwo_tpu/prover/prove.py:148-208: the
device-resident PlonkWithPoseidon prover at every size, with the channel
and tree class the caller names; prover/flow.py runs its stages.  Two
flavours are ported, in every prover: the default Poseidon31 channel with
`DeviceTree`, and the Sha256Poseidon31 pair (`Sha256ProverChannel`,
`Sha256DeviceTree`) of chain level 14 and the last layer.  Any other
channel or tree raises (`flavour`).  `prove` is always the resident path:
it does not route large domains to the streamed flow as the JAX package
does (`RSTPU_STREAM_LOG`, prove.py:190-200); a caller who wants the
streamed prover calls prover/stream.py's `prove_streamed`, which gives the
same bytes.  The JAX package's host flow and its environment switches have
no counterpart.  Nothing falls back to the CPU: `device="cuda"` without a
CUDA device raises.
"""

from __future__ import annotations

from ..proof.containers import PcsConfig, PlonkWithPoseidonProof
from ..verifier.arrays import require_device
from .channel import PoseidonChannel
from .commit import DeviceTree, Sha256DeviceTree
from .flow import PoseidonAir, Resident, prove_air
from .prove_sha256 import Sha256ProverChannel


def flavour(channel, tree_cls, device):
    """(channel, tree class) of a ported flavour on `device`: the
    Poseidon31 channel and `DeviceTree` when both are None, or the SHA-256
    pair as given, its channel set to grind on `device`."""
    if channel is None and tree_cls is None:
        return PoseidonChannel(device), DeviceTree
    if isinstance(channel, Sha256ProverChannel) and tree_cls is Sha256DeviceTree:
        channel.device = device
        return channel, tree_cls
    raise NotImplementedError(
        "the ported flavours are the default Poseidon31 channel and tree, and "
        "(Sha256ProverChannel(), Sha256DeviceTree); got "
        f"({type(channel).__name__}, {getattr(tree_cls, '__name__', tree_cls)})"
    )


def prove(
    trace: dict,
    config: PcsConfig,
    progress=None,
    device="cuda",
    channel=None,
    tree_cls=None,
) -> PlonkWithPoseidonProof:
    """Prove a PlonkWithPoseidon trace (`cs.generate_trace()`) on `device`.
    `progress`, if given, is called with a message after each stage."""
    device = require_device(device)
    channel, tree_cls = flavour(channel, tree_cls, device)
    return prove_air(PoseidonAir(), Resident(tree_cls), trace, config, progress, device, channel)
