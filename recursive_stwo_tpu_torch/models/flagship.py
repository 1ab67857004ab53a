"""Flagship model: the batched PlonkWithPoseidon proof verifier, the other
proof flavours' verifiers, and the recursion chain's circuits for the prover.

Twin of recursive_stwo_tpu/models/flagship.py.  Fixture loading
(`load_fixture`, copied) and host hint preparation run in numpy;
`verifier_step` puts a batch on a torch device and returns the verifier step
over it, and `verifier_step_np` does the same for the without-Poseidon
fixture np_small.  `sha_checks_step` batches the device checks of the
chain's two SHA-256-flavour artifacts (level 14 and the bitcoin-facing
last-layer proof).  `chain_level_trace` builds the circuit of a chain level
(1-14) on the host, and `last_layer_trace` the bitcoin-facing last layer's
over level 14; `proof_bytes` serialises a chain proof as its `.bin` holds
it, and `chain_artifact_sha256` reads the expected digests from
docs/chain_artifacts.txt.  `load_artifact` reads the chain's pickled proofs,
whose classes are named by their JAX-package paths, into the port's copies
of those classes.
"""

from __future__ import annotations

import os
import pickle
from functools import lru_cache

import numpy as np

from ..cs import scalar
from ..cs.system import PlonkWithPoseidonCS
from ..gadgets.fields import QM31Var
from ..gadgets.poseidon import Poseidon2Half
from ..proof.containers import FriConfig, PcsConfig, PlonkWithoutPoseidonProof
from ..proof.parse import parse_plonk_with_poseidon_proof, parse_plonk_without_poseidon_proof
from ..proof.serialize import serialize_plonk_with_poseidon_proof, serialize_plonk_without_poseidon_proof
from ..recursion.pipeline import build_last_circuit, build_verifier_circuit
from ..verifier import hints, sha256_merkle, transcript_host, verify, verify_np, verify_sha256
from ..verifier.arrays import ProofArrays, from_proofs_np, map_arrays, require_device, to_torch
from ..verifier.spec import NoPoseidonVerifierSpec, VerifierSpec
from ..verifier.verify_sha256_host import run_transcript_sha256np, run_transcript_sha256p31

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the committed stwo fixtures, data files of the JAX package
TESTDATA = os.path.join(REPO_DIR, "recursive_stwo_tpu", "testdata")

FIXTURE_INPUTS = {
    "small_proof": verify.INPUTS_ONE,
    "recursive_proof_16_15": verify.INPUTS_RECURSIVE,
}


@lru_cache(maxsize=None)
def load_fixture(name: str = "small_proof"):
    with open(os.path.join(TESTDATA, f"{name}.bin"), "rb") as f:
        proof = parse_plonk_with_poseidon_proof(f.read())
    spec = VerifierSpec.from_proof(proof)
    return proof, spec


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
# (examples/recursion_chain.py:57-72); levels 1-13 are proved with the
# Poseidon31 channel, SHA_LEVEL in the Sha256Poseidon31 flavour
CHAIN_LEVELS = {
    1: ("recursive_proof_16_15", 5, "level1-5", PRESETS["fast_prover"]),
    2: ("level1-5", 1, "level2-1", PRESETS["fast_prover2"]),
    3: ("level2-1", 1, "level3-1", PRESETS["standard"]),
    4: ("level3-1", 5, "level4-5", PRESETS["fast_prover"]),
    5: ("level4-5", 1, "level5-1", PRESETS["fast_prover2"]),
    6: ("level5-1", 1, "level6-1", PRESETS["standard"]),
    7: ("level6-1", 1, "level7-1", PRESETS["standard"]),
    8: ("level7-1", 1, "level8-1", PRESETS["fast_verifier"]),
    9: ("level8-1", 1, "level9-1", PRESETS["fast_verifier"]),
    10: ("level9-1", 1, "level10-1", PRESETS["fast_verifier2"]),
    11: ("level10-1", 1, "level11-1", PRESETS["fast_verifier2"]),
    12: ("level11-1", 1, "level12-1", PRESETS["fast_verifier3"]),
    13: ("level12-1", 1, "level13-1", PRESETS["fast_verifier3"]),
    14: ("level13-1", 1, "level14-1", PRESETS["fast_verifier3"]),
}
SHA_LEVEL = 14
# the last layer: level 14 verified in a PlonkWithoutPoseidon circuit and
# proved in the Sha256MerkleChannel flavour at the reference's output config
# (examples/last_layer.py:126-127, 150-168)
LAST_LAYER_CONFIG = PcsConfig(pow_bits=28, fri_config=FriConfig(0, 9, 8))
LAST_LAYER_ARTIFACT = "bitcoin_proof"
CHAIN_ARTIFACTS = os.path.join(REPO_DIR, "docs", "chain_artifacts.txt")


# JAX-package modules whose classes a chain artifact may name, and the
# port's copies of them
_ARTIFACT_MODULES = {"recursive_stwo_tpu.proof.containers": "recursive_stwo_tpu_torch.proof.containers"}


class _ArtifactUnpickler(pickle.Unpickler):
    """Reads a class of the JAX package's proof containers as the port's
    copy of it, and refuses any other name of that package."""

    def find_class(self, module: str, name: str):
        if module.partition(".")[0] == "recursive_stwo_tpu":
            if module not in _ARTIFACT_MODULES:
                raise pickle.UnpicklingError(f"{module}.{name} has no copy in the port")
            module = _ARTIFACT_MODULES[module]
        return super().find_class(module, name)


def load_artifact(path: str):
    """A committed artifact of the recursion chain (a pickled proof,
    examples/recursion_chain.py:79-80), with the port's proof classes."""
    with open(path, "rb") as f:
        return _ArtifactUnpickler(f).load()


def _chain_input(name: str):
    if name in FIXTURE_INPUTS:
        return load_fixture(name)[0]
    return load_artifact(os.path.join(CHAIN_DATA, f"{name}.pkl"))


def chain_level_trace(level: int, proof=None):
    """(trace, PcsConfig, path of the expected artifact) for recursion-chain
    level `level`, built as examples/recursion_chain.py:99-111 builds it: the
    input verified `multipliers` times into one circuit, the first time with
    the host cross-check, then pad, check, logup and invocation checks.
    `proof` is the level's input, the previous level's proof; by default it
    is read from the repo (the fixture or a committed artifact, which exist
    for the inputs of levels 1-3).  The artifact path may name a file the
    repo does not hold; `chain_artifact_sha256` has the digest of its bytes."""
    inp, multipliers, out, config = CHAIN_LEVELS[level]
    if proof is None:
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
    """The bytes of a chain proof's `.bin` (docs/chain_artifacts.txt): a
    without-Poseidon proof (the last layer) as "bytes32"
    (examples/last_layer.py:163-168); a PlonkWithPoseidon proof as
    "bytes32" when a root is raw bytes or a word of p or more (a SHA-256
    digest), else "m31x8" (examples/recursion_chain.py:242-252)."""
    if isinstance(proof, PlonkWithoutPoseidonProof):
        return serialize_plonk_without_poseidon_proof(proof, "bytes32")
    roots = np.asarray(proof.stark_proof.commitments)
    mode = "bytes32" if roots.dtype == np.uint8 or (roots >= (1 << 31) - 1).any() else "m31x8"
    return serialize_plonk_with_poseidon_proof(proof, mode)


@lru_cache(maxsize=None)
def chain_artifact_sha256() -> dict:
    """File name -> sha256 hex digest, for every line of
    docs/chain_artifacts.txt ("<digest>  examples/data/<name>"): the
    `.pkl` and `.bin` of every chain level and of the bitcoin proof."""
    out = {}
    with open(CHAIN_ARTIFACTS) as f:
        for line in f:
            if line.strip():
                digest, path = line.split()
                out[os.path.basename(path)] = digest
    return out


def expected_sha256(name: str) -> str:
    """The sha256 of `<name>.bin` (name as in CHAIN_LEVELS or
    LAST_LAYER_ARTIFACT): the digest a re-proved chain proof's
    `proof_bytes` must have."""
    return chain_artifact_sha256()[f"{name}.bin"]


def verifier_step(name: str = "small_proof", batch: int = 4, device="cuda"):
    """(step, arrays): the verifier over `batch` copies of a fixture, with the
    arrays already on `device`; step(arrays) returns the dict of checks."""
    device = require_device(device)
    spec, pa = prepared_arrays(name)
    inputs = FIXTURE_INPUTS[name]

    def step(arrays: ProofArrays):
        return verify.verify_batch(spec, arrays, inputs)

    return step, to_torch(tiled_batch(pa, batch), device)


# the without-Poseidon fixture and its public inputs (bench.py:185-188)
NP_FIXTURE_INPUTS = {"np_small": verify.INPUTS_RECURSIVE}


@lru_cache(maxsize=None)
def load_np_fixture(name: str = "np_small"):
    """(proof, spec) of a committed PlonkWithoutPoseidon fixture."""
    with open(os.path.join(TESTDATA, f"{name}.bin"), "rb") as f:
        proof = parse_plonk_without_poseidon_proof(f.read())
    return proof, NoPoseidonVerifierSpec.for_rows(proof.log_size, proof.config)


@lru_cache(maxsize=None)
def prepared_arrays_np(name: str = "np_small") -> tuple:
    """(spec, numpy ProofArrays of batch 1) for a without-Poseidon fixture."""
    proof, spec = load_np_fixture(name)
    pa = hints.prepare(
        spec, [proof], arrays_fn=from_proofs_np, transcript_fn=transcript_host.run_transcript_np
    )
    return spec, pa


def verifier_step_np(name: str = "np_small", batch: int = 4, device="cuda"):
    """(step, arrays): verify_batch_np over `batch` copies of a
    without-Poseidon fixture, the arrays already on `device`."""
    device = require_device(device)
    spec, pa = prepared_arrays_np(name)
    inputs = NP_FIXTURE_INPUTS[name]

    def step(arrays: ProofArrays):
        return verify_np.verify_batch_np(spec, arrays, inputs)

    return step, to_torch(tiled_batch(pa, batch), device)


# the SHA-256-flavour artifacts of the chain: level 14's Sha256Poseidon31
# proof, and the last layer's Sha256MerkleChannel PlonkWithoutPoseidon
# proof (examples/recursion_chain.py:143, examples/last_layer.py:132,174)
SHA_ARTIFACTS = {"level14": "level14-1", "bitcoin": "bitcoin_proof"}


def sha_artifact(kind: str):
    """A fresh copy of a SHA-256-flavour artifact ("level14" or "bitcoin")."""
    return load_artifact(os.path.join(CHAIN_DATA, f"{SHA_ARTIFACTS[kind]}.pkl"))


def sha_artifacts() -> tuple:
    """(level-14 proof, bitcoin proof), freshly loaded."""
    return sha_artifact("level14"), sha_artifact("bitcoin")


def _last_circuit(level14_proof):
    """The last-layer circuit over a level-14 proof: a PlonkWithoutPoseidon
    circuit that verifies it, with its Fiat-Shamir and decommitment data as
    packed public inputs (examples/last_layer.py:138-143)."""
    cs, _ = build_last_circuit(
        level14_proof, list(CHAIN_INPUTS),
        transcript_fn=lambda s, pa: run_transcript_sha256p31(s, level14_proof),
        hash_node_fn=sha256_merkle.hash_node,
    )
    return cs


def _public_inputs(cs) -> tuple:
    return tuple((i + 1, tuple(int(x) for x in cs.value(i + 1))) for i in range(cs.num_input))


def last_layer_trace(level14_proof):
    """(trace, PcsConfig, public inputs) of the last layer over a level-14
    proof: the circuit of examples/last_layer.py:138-150, to be proved with
    `prove_np` in the Sha256MerkleChannel flavour at LAST_LAYER_CONFIG
    (pow 28, FRI(0, 9, 8)); the inputs are those its verifier takes."""
    cs = _last_circuit(level14_proof)
    return cs.generate_trace(), LAST_LAYER_CONFIG, _public_inputs(cs)


@lru_cache(maxsize=None)
def bitcoin_inputs() -> tuple:
    """The bitcoin proof's 264 public inputs: the packed Fiat-Shamir and
    decommitment vector of the last-layer circuit over level 14
    (examples/last-layer/src/main.rs:113-186), rebuilt by building that
    circuit without proving it, as bench.py:213-222 does."""
    return _public_inputs(_last_circuit(sha_artifact("level14")))


def sha_inputs(kind: str) -> tuple:
    return CHAIN_INPUTS if kind == "level14" else bitcoin_inputs()


@lru_cache(maxsize=None)
def sha_prepared(kind: str) -> tuple:
    """(spec, numpy ProofArrays of batch 1, batch-1 host FSOutput) of a
    SHA-256-flavour artifact: the host SHA transcript and the root-asserting
    path expansion."""
    proof = sha_artifact(kind)
    if kind == "level14":
        spec = VerifierSpec.from_proof(proof)
        fs = run_transcript_sha256p31(spec, proof)
        kw = {}
    else:
        spec = NoPoseidonVerifierSpec.for_rows(proof.log_size, proof.config)
        fs = run_transcript_sha256np(spec, proof)
        kw = {"arrays_fn": from_proofs_np}
    pa = hints.prepare(spec, [proof], transcript_fn=lambda s, p: fs, hash_node_fn=sha256_merkle.hash_node, **kw)
    return spec, pa, fs


def sha_checks_step(kind: str, batch: int = 4, device="cuda"):
    """(step, arrays, fs): the SHA-256 flavour's device checks over `batch`
    copies of an artifact and of its FSOutput, both already on `device`;
    step(arrays, fs) returns the dict of checks."""
    device = require_device(device)
    spec, pa, fs = sha_prepared(kind)
    inputs = sha_inputs(kind)
    checks = verify_sha256.device_checks_p31 if kind == "level14" else verify_sha256.device_checks_np

    def step(arrays: ProofArrays, fs_b):
        return checks(spec, arrays, fs_b, inputs)

    return step, to_torch(tiled_batch(pa, batch), device), verify_sha256.tile_fs(fs, batch, device)
