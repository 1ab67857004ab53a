"""The port's SHA-256 flavours against the JAX package's, at tolerance 0, on
the chain's two SHA-256-flavour artifacts (examples/data/level14-1 and
bitcoin_proof): the SHA-256 core and channel, both host verifiers (the whole
dict), the fast paths on the CPU, a seeded byte-flip fuzz of both artifacts
(the verdict equal down to the failing named check).  The device checks
are held to the reference in tests/test_torch_sha256_device.py and
tests/test_torch_np.py."""

import dataclasses
import hashlib
import os
import pickle

import numpy as np
import pytest
import torch

from recursive_stwo_tpu.core import sha256 as r_sha
from recursive_stwo_tpu.proof.parse import parse_plonk_with_poseidon_proof as r_parse_wp
from recursive_stwo_tpu.proof.parse import parse_plonk_without_poseidon_proof as r_parse_np
from recursive_stwo_tpu.prover.prove_sha256 import Sha256ProverChannel as RChannel
from recursive_stwo_tpu.recursion.pipeline import build_last_circuit as r_build_last
from recursive_stwo_tpu.verifier import sha256_merkle as r_sha_merkle
from recursive_stwo_tpu.verifier import verify_sha256 as r_vs
from recursive_stwo_tpu_torch.core import sha256 as t_sha
from recursive_stwo_tpu_torch.models import flagship
from recursive_stwo_tpu_torch.proof.parse import parse_plonk_with_poseidon_proof as t_parse_wp
from recursive_stwo_tpu_torch.proof.parse import parse_plonk_without_poseidon_proof as t_parse_np
from recursive_stwo_tpu_torch.prover.prove_sha256 import Sha256ProverChannel as TChannel
from recursive_stwo_tpu_torch.prover.prove_sha256 import prove_sha256p31
from recursive_stwo_tpu_torch.verifier import verify_sha256 as t_vs
from recursive_stwo_tpu_torch.verifier import verify_sha256_host as t_vh

from test_torch_transcript import _compare

P = 2**31 - 1
KINDS = ("level14", "bitcoin")
HOST = {"level14": "verify_sha256p31_host", "bitcoin": "verify_sha256np_host"}
FAST = {"level14": "verify_sha256p31", "bitcoin": "verify_sha256np"}
PARSE = {"level14": (r_parse_wp, t_parse_wp), "bitcoin": (r_parse_np, t_parse_np)}


def _reference_artifact(kind):
    with open(os.path.join(flagship.CHAIN_DATA, f"{flagship.SHA_ARTIFACTS[kind]}.pkl"), "rb") as f:
        return pickle.load(f)


def _inputs(kind):
    return flagship.sha_inputs(kind)


def _plain(checks):
    """A verdict dict as {key: list of bools}, key order kept."""
    return {k: np.asarray(v).tolist() for k, v in checks.items()}


def _same(ref, got):
    assert list(ref) == list(got)
    for k in ref:
        r, g = np.asarray(ref[k]), np.asarray(got[k])
        assert (r.dtype, r.shape) == (g.dtype, g.shape) and np.array_equal(r, g), k


@pytest.mark.parametrize("K", [1, 8, 13, 16, 17, 40])
def test_sha256_words_matches_hashlib_and_reference(K):
    w = np.random.default_rng(K).integers(0, 2**32, size=(5, K), dtype=np.uint64).astype(np.uint32)
    got = t_sha.sha256_words(w)
    _same({"digests": r_sha.sha256_words(w)}, {"digests": got})
    for i in range(5):
        want = hashlib.sha256(w[i].astype(">u4").tobytes()).digest()
        assert np.array_equal(got[i], t_sha.digest_to_words(want))
        assert np.array_equal(t_sha.sha256_words_scalar(w[i]), got[i])


def test_channel_matches_reference():
    """The same mixes on both packages' SHA-256 prover channels give the
    same draws, digests and PoW nonce."""
    rng = np.random.default_rng(5)
    chans = (RChannel(), TChannel())
    for step in range(6):
        root = rng.integers(0, 2**32, 8, dtype=np.uint64).astype(np.uint32)
        felts = rng.integers(0, P, (2, 4))
        outs = []
        for ch in chans:
            ch.mix_root(root)
            ch.mix_one_felt(felts[0]) if step % 2 else ch.mix_two_felts(felts[0], felts[1])
            ch.mix_u64(step * 2**40 + 3)
            outs.append((*ch.draw_felts(), ch.draw_felt(), ch.ch.digest, ch.ch.n_sent, ch.ch.draw_u32s()))
        for a, b in zip(*outs):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    assert chans[0].grind_pow(10) == chans[1].grind_pow(10)


def test_prove_sha256p31_matches_reference(monkeypatch):
    """The port's prove_sha256p31 on the CPU equals the JAX host flow's
    (tests/test_sha256_flavor.py:98) on the demo circuit, in "bytes32"
    bytes, and the port's host verifier accepts it."""
    from recursive_stwo_tpu.proof.serialize import serialize_plonk_with_poseidon_proof as r_ser
    from recursive_stwo_tpu.prover.prove_sha256 import prove_sha256p31 as r_prove_sha256p31

    from test_torch_chain import CONFIG, T_CONFIG

    monkeypatch.setenv("RSTPU_DEVICE_PROVER", "0")
    trace = flagship.demo_trace()
    got = prove_sha256p31(trace, T_CONFIG, device="cpu")
    assert flagship.proof_bytes(got) == r_ser(r_prove_sha256p31(trace, CONFIG), "bytes32")
    assert np.asarray(got.stark_proof.commitments).dtype == np.uint32
    assert t_vh.verify_sha256p31_host(got, flagship.CHAIN_INPUTS)["ok"].all()


def test_bitcoin_inputs_match_reference():
    """The bitcoin proof's public inputs from the port's build_last_circuit
    equal those of the JAX package's over its own load of level 14
    (bench.py:213-222), all 264 tuples."""
    lvl14 = _reference_artifact("level14")
    cs, _ = r_build_last(
        lvl14, list(flagship.CHAIN_INPUTS),
        transcript_fn=lambda s, pa: r_vs.run_transcript_sha256p31(s, lvl14),
        hash_node_fn=r_sha_merkle.hash_node,
    )
    ref = tuple((i + 1, tuple(int(x) for x in cs.value(i + 1))) for i in range(cs.num_input))
    assert len(ref) == 264 and flagship.bitcoin_inputs() == ref


@pytest.mark.parametrize("kind", KINDS)
def test_host_verifier_matches_reference(kind):
    ref = getattr(r_vs, HOST[kind])(_reference_artifact(kind), _inputs(kind))
    got = getattr(t_vh, HOST[kind])(flagship.sha_artifact(kind), _inputs(kind))
    _same(ref, got)
    assert _plain(got) == {"pow": [True], "total_sum": [True], "composition": [True],
                           "merkle_fri": [True], "ok": [True]}


@pytest.mark.parametrize("kind", KINDS)
def test_transcript_matches_reference(kind):
    name = "run_transcript_sha256p31" if kind == "level14" else "run_transcript_sha256np"
    spec, _, _ = flagship.sha_prepared(kind)
    ref = getattr(r_vs, name)(spec, _reference_artifact(kind))
    got = getattr(t_vh, name)(spec, flagship.sha_artifact(kind))
    _compare(ref, got)


def _corruptions(kind):
    """The corruption cases of tests/test_sha256_device.py: a sampled value
    (level 14); a first-layer FRI witness, and one wrong public input
    (bitcoin)."""
    if kind == "level14":
        def sample(p):
            col = p.stark_proof.sampled_values[2][0]
            col[0] = tuple((int(x) + 1) % P for x in col[0])
        return [("sampled value", sample, None)]

    def witness(p):
        fw = np.asarray(p.stark_proof.fri_proof.first_layer.fri_witness, np.uint32).copy()
        fw.flat[0] = (int(fw.flat[0]) + 1) % P
        p.stark_proof.fri_proof.first_layer.fri_witness = fw

    wrong = list(_inputs(kind))
    idx, val = wrong[5]
    wrong[5] = (idx, ((val[0] + 1) % P,) + val[1:])
    return [("fri witness", witness, None), ("public input", None, tuple(wrong))]


@pytest.mark.parametrize("kind", KINDS)
def test_fast_path_on_cpu_matches_reference(kind):
    """The fast path with device='cpu': the dict of the JAX fast path, whose
    values the JAX host verifier gives (the JAX fast path itself jits its
    composition, about 30 s a flavour on a CPU; the bitcoin one is held to
    the port's in tests/test_torch_sha256_fast.py); clean and corrupted."""
    cases = [("clean", None, None)] + _corruptions(kind)
    for label, corrupt, inputs in cases:
        ref_proof, proof = _reference_artifact(kind), flagship.sha_artifact(kind)
        if corrupt:
            corrupt(ref_proof)
            corrupt(proof)
        inputs = inputs or _inputs(kind)
        ref = getattr(r_vs, HOST[kind])(ref_proof, inputs)
        got = getattr(t_vs, FAST[kind])(proof, inputs, device="cpu")
        if ref["merkle_fri"][0]:
            ref = {k: ref[k] for k in ("merkle_fri", "pow", "total_sum", "composition", "ok")}
        else:
            ref = {"ok": ref["ok"], "merkle_fri": ref["merkle_fri"]}
        _same(ref, got)
        assert bool(got["ok"][0]) == (label == "clean"), label
    if kind == "bitcoin":
        assert _plain(got)["total_sum"] == [False]


def test_fast_path_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        t_vs.verify_sha256np(flagship.sha_artifact("bitcoin"), _inputs("bitcoin"))


def _digest_words(obj):
    """A proof parsed with 32-byte digests, with every digest as the 8
    big-endian uint32 words the SHA-256 flavours' verifiers read."""
    if isinstance(obj, np.ndarray) and obj.dtype == np.uint8 and obj.shape[-1:] == (32,):
        return np.ascontiguousarray(obj).view(">u4").astype(np.uint32)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(
            obj, **{f.name: _digest_words(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
        )
    if isinstance(obj, (list, tuple)):
        return type(obj)(_digest_words(v) for v in obj)
    return obj


def _verdict(parse, verify, data, inputs):
    """The host verdict on serialized proof bytes: the checks dict, or the
    name of what parsing or verifying raised."""
    try:
        return _plain(verify(_digest_words(parse(data, "bytes32")), inputs))
    except Exception as e:  # a malformed proof may fail anywhere on the host
        return type(e).__name__


@pytest.mark.parametrize("kind", KINDS)
def test_byte_flip_fuzz_matches_reference(kind):
    """8 seeded corruptions of the committed .bin (1-4 bytes flipped each):
    the port's host verdict equals the JAX package's, down to the failing
    named check or the exception raised, and no corruption is accepted."""
    with open(os.path.join(flagship.CHAIN_DATA, f"{flagship.SHA_ARTIFACTS[kind]}.bin"), "rb") as f:
        raw = f.read()
    r_parse, t_parse = PARSE[kind]
    r_verify, t_verify = getattr(r_vs, HOST[kind]), getattr(t_vh, HOST[kind])
    inputs = _inputs(kind)
    assert _verdict(t_parse, t_verify, raw, inputs)["ok"] == [True]
    rng = np.random.default_rng(2026)
    for trial in range(8):
        data = bytearray(raw)
        for pos in rng.integers(0, len(data), int(rng.integers(1, 5))):
            data[int(pos)] ^= int(rng.integers(1, 256))
        ref = _verdict(r_parse, r_verify, bytes(data), inputs)
        got = _verdict(t_parse, t_verify, bytes(data), inputs)
        assert got == ref, trial
        assert isinstance(got, str) or got["ok"] == [False], trial


def test_artifacts_load_as_the_ports_classes():
    for proof in flagship.sha_artifacts():
        assert type(proof).__module__ == "recursive_stwo_tpu_torch.proof.containers"
