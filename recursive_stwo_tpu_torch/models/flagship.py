"""Flagship model: the batched PlonkWithPoseidon proof verifier, and the
recursion chain's first two levels for the prover.

Twin of recursive_stwo_tpu/models/flagship.py.  Fixture loading and host hint
preparation are the reference's own (numpy); `verifier_step` puts a batch on
a torch device and returns the verifier step over it.  `chain_level_trace`
builds the circuit of chain level 1 or 2 on the host (no jax) with the
expected proof artifact beside it.
"""

from __future__ import annotations

import os
import pickle
from functools import lru_cache

import numpy as np
import torch

from recursive_stwo_tpu.cs import scalar
from recursive_stwo_tpu.cs.system import PlonkWithPoseidonCS
from recursive_stwo_tpu.gadgets.fields import QM31Var
from recursive_stwo_tpu.gadgets.poseidon import Poseidon2Half
from recursive_stwo_tpu.models.flagship import load_fixture
from recursive_stwo_tpu.proof.containers import FriConfig, PcsConfig
from recursive_stwo_tpu.proof.serialize import serialize_plonk_with_poseidon_proof
from recursive_stwo_tpu.recursion.pipeline import build_verifier_circuit
from recursive_stwo_tpu.verifier import hints

from ..verifier import verify
from ..verifier.arrays import ProofArrays, map_arrays, to_torch

FIXTURE_INPUTS = {
    "small_proof": verify.INPUTS_ONE,
    "recursive_proof_16_15": verify.INPUTS_RECURSIVE,
}


@lru_cache(maxsize=None)
def prepared_arrays(name: str = "small_proof") -> tuple:
    """(spec, numpy ProofArrays of batch 1) for a committed fixture."""
    proof, spec = load_fixture(name)
    return spec, hints.prepare(spec, [proof])


def tiled_batch(pa: ProofArrays, batch: int) -> ProofArrays:
    """Replicate a prepared single-proof batch to size `batch` (host-side,
    fresh writable arrays)."""
    return map_arrays(
        lambda x: np.ascontiguousarray(np.broadcast_to(x, (batch,) + x.shape[1:])), pa
    )


REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CHAIN_DATA = os.path.join(REPO_DIR, "examples", "data")
# every chain proof carries the verifier circuit's three bootstrap public
# inputs (examples/recursion_chain.py:43)
CHAIN_INPUTS = ((1, (1, 0, 0, 0)), (2, (0, 1, 0, 0)), (3, (0, 0, 1, 0)))
# the chain's six PcsConfig presets (examples/recursion_chain.py:45-53)
PRESETS = {
    "standard": PcsConfig(pow_bits=20, fri_config=FriConfig(8, 5, 16)),
    "fast_prover": PcsConfig(pow_bits=20, fri_config=FriConfig(8, 1, 80)),
    "fast_prover2": PcsConfig(pow_bits=20, fri_config=FriConfig(8, 3, 27)),
    "fast_verifier": PcsConfig(pow_bits=23, fri_config=FriConfig(8, 7, 11)),
    "fast_verifier2": PcsConfig(pow_bits=20, fri_config=FriConfig(8, 8, 10)),
    "fast_verifier3": PcsConfig(pow_bits=28, fri_config=FriConfig(7, 9, 8)),
}
# level -> (input, verifications in-circuit, output artifact, PcsConfig)
# (examples/recursion_chain.py:57-59)
CHAIN_LEVELS = {
    1: ("recursive_proof_16_15", 5, "level1-5", PRESETS["fast_prover"]),
    2: ("level1-5", 1, "level2-1", PRESETS["fast_prover2"]),
}


def _chain_input(name: str):
    if name in FIXTURE_INPUTS:
        return load_fixture(name)[0]
    # a committed artifact of the recursion chain (examples/recursion_chain.py:79-80)
    with open(os.path.join(CHAIN_DATA, f"{name}.pkl"), "rb") as f:
        return pickle.load(f)


def chain_level_trace(level: int):
    """(trace, PcsConfig, path of the expected artifact) for recursion-chain
    level 1 or 2, built as examples/recursion_chain.py:99-111 builds it: the
    input verified `multipliers` times into one circuit, the first time with
    the host cross-check, then pad, check, logup and invocation checks."""
    inp, multipliers, out, config = CHAIN_LEVELS[level]
    proof = _chain_input(inp)
    cs = None
    for k in range(multipliers):
        cs, _ = build_verifier_circuit(proof, list(CHAIN_INPUTS), cs=cs, finalize=False, cross_check=(k == 0))
    cs.pad()
    cs.check_arithmetics()
    cs.populate_logup_arguments()
    cs.check_poseidon_invocations()
    return cs.generate_trace(), config, os.path.join(CHAIN_DATA, f"{out}.pkl")


DEMO_CONFIG = PcsConfig(pow_bits=5, fri_config=FriConfig(1, 3, 9))


def demo_trace() -> dict:
    """A small PlonkWithPoseidon trace (log sizes 5/8): a QM31 power check
    and one Poseidon2 permutation, the circuit of
    tests/test_device_prover.py:116-131.  With DEMO_CONFIG its proof takes
    seconds on a CPU."""
    cs = PlonkWithPoseidonCS()
    a = (123456789, 987654321, 555, 2**30)
    av = QM31Var.new_witness(cs, a)
    bv = QM31Var.new_witness(cs, scalar.q_pow(a, 100))
    av.pow(100).equalverify(bv)
    left = Poseidon2Half.new_witness(cs, list(range(8)))
    right = Poseidon2Half.new_witness(cs, list(range(8, 16)))
    Poseidon2Half.permute_get_rate(left, right)
    cs.pad()
    cs.check_arithmetics()
    cs.populate_logup_arguments()
    cs.check_poseidon_invocations()
    return cs.generate_trace()


def proof_bytes(proof) -> bytes:
    """The m31x8 serialisation of a PlonkWithPoseidon proof (the chain
    artifacts' format, docs/chain_artifacts.txt)."""
    return serialize_plonk_with_poseidon_proof(proof, "m31x8")


def artifact_bytes(path: str) -> bytes:
    """m31x8 bytes of a committed chain artifact (a pickled proof)."""
    with open(path, "rb") as f:
        return proof_bytes(pickle.load(f))


def verifier_step(name: str = "small_proof", batch: int = 4, device="cuda"):
    """(step, arrays): the verifier over `batch` copies of a fixture, with the
    arrays already on `device`; step(arrays) returns the dict of checks."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is false")
    spec, pa = prepared_arrays(name)
    inputs = FIXTURE_INPUTS[name]

    def step(arrays: ProofArrays):
        return verify.verify_batch(spec, arrays, inputs)

    return step, to_torch(tiled_batch(pa, batch), device)
