"""The port's prover entry point.

Twin of the routing in recursive_stwo_tpu/prover/prove.py:148-208 for the
default Poseidon31 channel: the device-resident prover at every size.  The
SHA-256 flavour, other channels, the streamed prover and the
without-Poseidon prover are not ported yet (ROADMAP.md, section 1, the
queue of modules to port); asking for them raises.  Nothing falls back to
the CPU: `device="cuda"` without a CUDA device raises.
"""

from __future__ import annotations

from ..proof.containers import PcsConfig, PlonkWithPoseidonProof
from ..verifier.arrays import require_device
from .device_prove import prove_device


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
    if channel is not None or tree_cls is not None:
        raise NotImplementedError(
            "only the default Poseidon31 channel and tree are ported; the SHA-256 "
            "flavour and other channels wait in ROADMAP.md's queue of modules to port"
        )
    return prove_device(trace, config, progress, require_device(device))
