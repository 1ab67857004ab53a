"""The device-resident PlonkWithoutPoseidon prover (the last-layer output AIR).

Twin of recursive_stwo_tpu/prover/prove_np.py::prove_np: prover/flow.py's
stages over its one table (`NoPoseidonAir`) with resident trees, so the
proof is byte-identical to the JAX package's.  `channel` / `tree_cls` pick
the flavour as `prove` does: the Poseidon31 default, or
(`Sha256ProverChannel()`, `Sha256DeviceTree`) for the bitcoin proof's
Sha256MerkleChannel flavour (examples/last_layer.py:150-155).  Like
`prove`, it never routes by domain size to the streamed flow
(prove_np.py:149-155 in the JAX package): that is prover/stream.py's
`prove_np_streamed`, called by name.
"""

from __future__ import annotations

from ..proof.containers import PcsConfig, PlonkWithoutPoseidonProof
from ..verifier.arrays import require_device
from .flow import NoPoseidonAir, Resident, prove_air
from .prove import flavour


def prove_np(
    trace: dict,
    config: PcsConfig,
    progress=None,
    device="cuda",
    channel=None,
    tree_cls=None,
) -> PlonkWithoutPoseidonProof:
    """Prove a PlonkWithoutPoseidonCS trace (`cs.generate_trace()`) on
    `device`.  `progress`, if given, is called with a message after each
    stage."""
    device = require_device(device)
    channel, tree_cls = flavour(channel, tree_cls, device)
    return prove_air(NoPoseidonAir(), Resident(tree_cls), trace, config, progress, device, channel)
