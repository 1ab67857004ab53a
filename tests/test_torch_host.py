"""The port's copies of the JAX package's host layers (proof parsing, hint
preparation, the circuit builder and the last-layer circuit, the AIR
columns, the native host kernels, the SHA-256 core, channel, Merkle hasher
and host verifier) against the JAX package's own modules, on the committed fixtures, at
tolerance 0: every array equal in dtype, shape and value, every dict's keys
in the same order, every container of the same name and fields."""

import dataclasses
import os
import pickle

import numpy as np
import pytest

from recursive_stwo_tpu.core import sha256 as r_sha
from recursive_stwo_tpu.cs import scalar as r_scalar
from recursive_stwo_tpu.cs.system import PlonkWithPoseidonCS as RCS
from recursive_stwo_tpu.gadgets.fields import QM31Var as RQM31Var
from recursive_stwo_tpu.gadgets.poseidon import Poseidon2Half as RPoseidon2Half
from recursive_stwo_tpu.models import flagship as r_flagship
from recursive_stwo_tpu.proof import parse as r_parse
from recursive_stwo_tpu.prover import air as r_air
from recursive_stwo_tpu.recursion import composition as r_comp
from recursive_stwo_tpu.recursion import pipeline as r_pipeline
from recursive_stwo_tpu.utils import native as r_native
from recursive_stwo_tpu.verifier import arrays as r_arrays
from recursive_stwo_tpu.verifier import hints as r_hints
from recursive_stwo_tpu.verifier import spec as r_spec_mod
from recursive_stwo_tpu.verifier import sha256_channel as r_channel
from recursive_stwo_tpu.verifier import sha256_merkle as r_merkle
from recursive_stwo_tpu.verifier import verify_sha256 as r_vs
from recursive_stwo_tpu_torch.core import sha256 as t_sha
from recursive_stwo_tpu_torch.models import flagship
from recursive_stwo_tpu_torch.proof import parse as t_parse
from recursive_stwo_tpu_torch.prover import air as t_air
from recursive_stwo_tpu_torch.recursion import composition as t_comp
from recursive_stwo_tpu_torch.recursion import pipeline as t_pipeline
from recursive_stwo_tpu_torch.utils import native as t_native
from recursive_stwo_tpu_torch.verifier import hints as t_hints
from recursive_stwo_tpu_torch.verifier import sha256_channel as t_channel
from recursive_stwo_tpu_torch.verifier import sha256_merkle as t_merkle
from recursive_stwo_tpu_torch.verifier import verify_sha256_host as t_vh
from recursive_stwo_tpu_torch.verifier.arrays import ProofArrays, carry_across

FIXTURES = ("small_proof", "recursive_proof_16_15")
TESTDATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "recursive_stwo_tpu", "testdata")


def assert_same(ref, got, path="value"):
    """Structural equality at tolerance 0, across the two packages' classes."""
    if isinstance(ref, np.ndarray) or isinstance(got, np.ndarray):
        ref, got = np.asarray(ref), np.asarray(got)
        assert (ref.dtype, ref.shape) == (got.dtype, got.shape), path
        assert np.array_equal(ref, got), path
    elif isinstance(ref, dict):
        assert isinstance(got, dict) and list(ref) == list(got), path
        for k in ref:
            assert_same(ref[k], got[k], f"{path}[{k!r}]")
    elif isinstance(ref, (tuple, list)):
        assert type(ref).__name__ == type(got).__name__ and len(ref) == len(got), path
        assert getattr(ref, "_fields", None) == getattr(got, "_fields", None), path
        for i, (a, b) in enumerate(zip(ref, got)):
            assert_same(a, b, f"{path}[{i}]")
    elif dataclasses.is_dataclass(ref):
        assert type(ref).__name__ == type(got).__name__, path
        assert type(got).__module__.startswith("recursive_stwo_tpu_torch."), path
        for f in dataclasses.fields(ref):
            assert_same(getattr(ref, f.name), getattr(got, f.name), f"{path}.{f.name}")
    else:
        assert type(ref) is type(got) and ref == got, path


@pytest.mark.parametrize("name", FIXTURES)
def test_parse_matches_reference(name):
    with open(os.path.join(TESTDATA, f"{name}.bin"), "rb") as f:
        data = f.read()
    assert_same(r_parse.parse_plonk_with_poseidon_proof(data), t_parse.parse_plonk_with_poseidon_proof(data))


@pytest.mark.parametrize("name", FIXTURES)
def test_hints_prepare_matches_reference(name):
    r_proof, r_spec = r_flagship.load_fixture(name)
    t_proof, t_spec = flagship.load_fixture(name)
    assert_same(r_spec, t_spec)
    got = t_hints.prepare(t_spec, [t_proof])
    assert isinstance(got, ProofArrays)
    assert_same(r_hints.prepare(r_spec, [r_proof]), got)


def test_carry_across_rebuilds_the_ports_containers():
    r_proof, r_spec = r_flagship.load_fixture("small_proof")
    ref = r_hints.prepare(r_spec, [r_proof])
    got = carry_across(ref)
    assert isinstance(got, ProofArrays) and type(ref) is not ProofArrays
    assert_same(ref, got)


def _demo_trace(cs_cls, qm31_var, half, q_pow):
    """models/flagship.demo_trace on either package's circuit builder."""
    cs = cs_cls()
    a = (123456789, 987654321, 555, 2**30)
    av = qm31_var.new_witness(cs, a)
    bv = qm31_var.new_witness(cs, q_pow(a, 100))
    av.pow(100).equalverify(bv)
    left = half.new_witness(cs, list(range(8)))
    right = half.new_witness(cs, list(range(8, 16)))
    half.permute_get_rate(left, right)
    cs.pad()
    cs.check_arithmetics()
    cs.populate_logup_arguments()
    cs.check_poseidon_invocations()
    return cs.generate_trace()


def _reference_demo_trace():
    return _demo_trace(RCS, RQM31Var, RPoseidon2Half, r_scalar.q_pow)


def test_demo_circuit_trace_matches_reference():
    assert_same(_reference_demo_trace(), flagship.demo_trace())


def test_verifier_circuit_trace_matches_reference():
    """build_verifier_circuit on small_proof, the circuit of chain level 1's
    kind, every column of its trace."""
    r_proof, _ = r_flagship.load_fixture("small_proof")
    t_proof, _ = flagship.load_fixture("small_proof")
    inputs = [(1, (1, 0, 0, 0))]
    r_cs, _ = r_pipeline.build_verifier_circuit(r_proof, inputs)
    t_cs, _ = t_pipeline.build_verifier_circuit(t_proof, inputs)
    assert_same(r_cs.generate_trace(), t_cs.generate_trace())


def test_air_columns_match_reference():
    r_trace, t_trace = _reference_demo_trace(), flagship.demo_trace()
    r_plonk, t_plonk = r_air.plonk_columns(r_trace), t_air.plonk_columns(t_trace)
    r_pos, t_pos = r_air.poseidon_columns(r_trace), t_air.poseidon_columns(t_trace)
    assert_same(r_plonk, t_plonk)
    assert_same(r_pos, t_pos)
    for log in (r_plonk[0].shape[1].bit_length() - 1, r_pos[2]):
        assert_same(r_air.coset_to_domain_perm(log), t_air.coset_to_domain_perm(log))
    z4, alpha4 = (11, 22, 33, 44), (55, 66, 77, 88)
    for (pre, tr), evaluate in (((r_plonk), "evaluate_plonk"), ((r_pos[0], r_pos[1]), "evaluate_poseidon")):
        ref = r_air.interaction_columns(pre, tr, z4, alpha4, getattr(r_comp, evaluate))
        got = t_air.interaction_columns(pre, tr, z4, alpha4, getattr(t_comp, evaluate))
        assert_same(ref, got)


@pytest.mark.parametrize("bits", [8, 14])
def test_native_grind_matches_reference(bits):
    if not (r_native.available() and t_native.available()):
        pytest.skip("no C++ compiler for the native host kernels")
    digest = np.random.default_rng(bits).integers(0, 2**31 - 1, 8).astype(np.uint32)
    assert t_native.grind(digest, bits) == r_native.grind(digest, bits)
    states = np.random.default_rng(bits + 1).integers(0, 2**31 - 1, (33, 16)).astype(np.uint32)
    assert_same(r_native.permute_batch(states), t_native.permute_batch(states))


def test_sha256_core_and_merkle_copies_match_reference():
    """core/sha256 and verifier/sha256_merkle: the constants, one
    compression, node hashes and whole trees of mixed column sizes (below
    and above the native kernels' thresholds)."""
    assert_same(r_sha._K, t_sha._K)
    assert_same(r_sha._H0, t_sha._H0)
    rng = np.random.default_rng(14)
    state, block = (rng.integers(0, 2**32, (9, n), dtype=np.uint64).astype(np.uint32) for n in (8, 16))
    assert_same(r_sha.compress(state, block), t_sha.compress(state, block))
    for max_log in (5, 8):
        cols = {
            max_log: rng.integers(0, 2**31 - 1, (5, 1 << max_log)).astype(np.uint32),
            max_log - 2: rng.integers(0, 2**31 - 1, (3, 1 << (max_log - 2))).astype(np.uint32),
        }
        levels = t_merkle.merkle_levels(cols)
        assert_same(r_merkle.merkle_levels(cols), levels)
        leaf = cols[max_log][:, 0]
        assert_same(r_merkle.hash_node(None, leaf), t_merkle.hash_node(None, leaf))
        kids = (levels[0][0], levels[0][1])
        assert_same(r_merkle.hash_node(kids, leaf[:2]), t_merkle.hash_node(kids, leaf[:2]))


@pytest.mark.parametrize("variant", [None, {"felt_chain": "per_felt", "draw_mode": "counter8"}])
def test_sha256_channel_copy_matches_reference(variant):
    """verifier/sha256_channel: mixes, draws and the PoW test, step by step."""
    r_ch, t_ch = r_channel.Sha256Channel(variant), t_channel.Sha256Channel(variant)
    rng = np.random.default_rng(31)
    for step in range(5):
        root = bytes(rng.integers(0, 256, 32, dtype=np.uint8))
        felts = [tuple(int(x) for x in f) for f in rng.integers(0, 2**31 - 1, (3, 4))]
        outs = []
        for ch in (r_ch, t_ch):
            ch.mix_root(root)
            ch.mix_u64(step * 2**33 + 7)
            ch.mix_felts(felts[: 1 + step % 3])
            outs.append((ch.draw_felts(2), ch.draw_felt(), ch.draw_u32s(), ch.digest, ch.n_sent,
                         ch.trailing_zeros(), ch.verify_pow_nonce(3, step)))
        assert outs[0] == outs[1]


def _reference_level14():
    with open(os.path.join(flagship.CHAIN_DATA, "level14-1.pkl"), "rb") as f:
        return pickle.load(f)


def test_last_circuit_trace_matches_reference():
    """recursion/last via build_last_circuit: the last-layer circuit over
    chain level 14 (the SHA-256-flavour input the bitcoin proof verifies),
    every column of its trace, and its public inputs."""
    r_lvl14, t_lvl14 = _reference_level14(), flagship.sha_artifact("level14")
    inputs = list(flagship.CHAIN_INPUTS)
    r_cs, _ = r_pipeline.build_last_circuit(
        r_lvl14, inputs, transcript_fn=lambda s, pa: r_vs.run_transcript_sha256p31(s, r_lvl14),
        hash_node_fn=r_merkle.hash_node,
    )
    t_cs, _ = t_pipeline.build_last_circuit(
        t_lvl14, inputs, transcript_fn=lambda s, pa: t_vh.run_transcript_sha256p31(s, t_lvl14),
        hash_node_fn=t_merkle.hash_node,
    )
    assert r_cs.num_input == t_cs.num_input == 264
    assert_same(r_cs.generate_trace(), t_cs.generate_trace())


def test_sha256_host_verifier_copy_matches_reference():
    """verifier/verify_sha256_host: the SHA-256 transcripts (FSOutputs),
    `_q1`, the batched public-input sum over the bitcoin proof's 264 inputs,
    and the SHA-flavour hint preparation (prepare's "sha256" dispatch)."""
    level14, bitcoin = flagship.sha_artifacts()
    with open(os.path.join(flagship.CHAIN_DATA, "bitcoin_proof.pkl"), "rb") as f:
        r_bitcoin = pickle.load(f)
    for kind, r_proof, t_proof in (("level14", _reference_level14(), level14), ("bitcoin", r_bitcoin, bitcoin)):
        spec, pa, fs = flagship.sha_prepared(kind)
        if kind == "level14":
            name, r_spec, kw = "run_transcript_sha256p31", r_spec_mod.VerifierSpec.from_proof(r_proof), {}
        else:
            name, kw = "run_transcript_sha256np", {"arrays_fn": r_arrays.from_proofs_np}
            r_spec = r_spec_mod.NoPoseidonVerifierSpec.for_rows(r_proof.log_size, r_proof.config)
        assert_same(r_spec, spec)
        ref = getattr(r_vs, name)(r_spec, r_proof)
        assert_same(ref, getattr(t_vh, name)(spec, t_proof))
        assert_same(ref, fs)
        r_pa = r_hints.prepare(r_spec, [r_proof], transcript_fn=lambda s, p: ref, hash_node_fn=r_merkle.hash_node, **kw)
        assert_same(r_pa, pa)
    inputs = flagship.bitcoin_inputs()
    assert_same(r_vs._input_sum(ref, inputs), t_vh._input_sum(fs, inputs))
    assert_same(r_vs._q1((1, 2, 3, 4)), t_vh._q1((1, 2, 3, 4)))
