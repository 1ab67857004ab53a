"""The port's provers of the recursion chain's end (the SHA-256 tree,
prove_np in both flavours, the last layer) and the chain tool's tables,
against the JAX package on the CPU at tolerance 0: proofs compared as the
bytes their artifacts hold (m31x8 for the Poseidon31 channel, "bytes32" for
the SHA-256 flavours), trees level by level, the chain's levels and presets
against examples/recursion_chain.py, and the artifact digests against the
committed files."""

import hashlib
import importlib.util
import os
import pickle
from functools import lru_cache

import numpy as np
import pytest
import torch

from recursive_stwo_tpu.cs.system import PlonkWithoutPoseidonCS
from recursive_stwo_tpu.gadgets.fields import QM31Var
from recursive_stwo_tpu.gadgets.poseidon import Poseidon2Half
from recursive_stwo_tpu.proof.containers import FriConfig, PcsConfig
from recursive_stwo_tpu.proof.serialize import serialize_plonk_without_poseidon_proof as r_ser_np
from recursive_stwo_tpu.prover import fri as r_fri
from recursive_stwo_tpu.prover.commit import Sha256CommittedTree
from recursive_stwo_tpu.prover.prove_np import prove_np as r_prove_np
from recursive_stwo_tpu.prover.prove_sha256 import Sha256ProverChannel as RChannel
from recursive_stwo_tpu.prover.prove_sha256 import prove_sha256p31 as r_prove_sha256p31
from recursive_stwo_tpu.recursion.pipeline import build_last_circuit as r_build_last
from recursive_stwo_tpu.verifier import sha256_merkle as r_sha_merkle
from recursive_stwo_tpu.verifier import verify_sha256 as r_vs
from recursive_stwo_tpu_torch.models import flagship
from recursive_stwo_tpu_torch.proof.containers import FriConfig as TFriConfig
from recursive_stwo_tpu_torch.proof.containers import PcsConfig as TPcsConfig
from recursive_stwo_tpu_torch.proof.serialize import serialize_plonk_without_poseidon_proof as t_ser_np
from recursive_stwo_tpu_torch.prover import commit as t_commit
from recursive_stwo_tpu_torch.prover import fri_host as t_fri_host
from recursive_stwo_tpu_torch.prover import quotients as t_quot
from recursive_stwo_tpu_torch.prover.prove_np import prove_np as t_prove_np
from recursive_stwo_tpu_torch.prover.prove_sha256 import Sha256ProverChannel as TChannel
from recursive_stwo_tpu_torch.prover.prove_sha256 import prove_sha256p31 as t_prove_sha256p31
from recursive_stwo_tpu_torch.tools import chain
from recursive_stwo_tpu_torch.verifier import hints, transcript_host
from recursive_stwo_tpu_torch.verifier import verify_sha256_host as t_vh
from recursive_stwo_tpu_torch.verifier.arrays import from_proofs_np, to_torch
from recursive_stwo_tpu_torch.verifier.spec import NoPoseidonVerifierSpec
from recursive_stwo_tpu_torch.verifier.verify import INPUTS_RECURSIVE
from recursive_stwo_tpu_torch.verifier.verify_np import verify_batch_np
from test_torch_verify import REPO, run_blocked

P = 2**31 - 1


def _configs(pow_bits, *fri):
    """The same PcsConfig in each package's classes (a proof carries it, and
    each package's verifier compares it with its own spec's)."""
    return PcsConfig(pow_bits, FriConfig(*fri)), TPcsConfig(pow_bits, TFriConfig(*fri))


# the light configs of tests/test_sha256_flavor.py and tests/test_prover_np.py
CONFIG, T_CONFIG = _configs(5, 1, 2, 8)
NP_CONFIG, T_NP_CONFIG = _configs(5, 2, 2, 8)
# the pairs each package's prove_np takes for the Sha256MerkleChannel flavour
SHA_PAIRS = {"reference": (RChannel, Sha256CommittedTree), "port": (TChannel, t_commit.Sha256DeviceTree)}


def _rand(seed, *shape):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.int64)


@lru_cache(maxsize=None)
def _np_trace():
    """The circuit of tests/test_prover_np.py: every without-Poseidon gate."""
    cs = PlonkWithoutPoseidonCS()
    left = Poseidon2Half.new_witness(cs, tuple(range(1, 9)))
    right = Poseidon2Half.new_witness(cs, tuple(range(9, 17)))
    rate = Poseidon2Half.permute_get_rate(left, right)
    rate.equalverify(rate)
    x = QM31Var.new_witness(cs, (5, 6, 7, 8))
    y = (x * x) + x
    y.equalverify(y)
    cs.pad()
    cs.check_arithmetics()
    cs.populate_logup_arguments()
    return cs.generate_trace()


def _flavour(name, package):
    if name == "poseidon31":
        return {}
    channel, tree = SHA_PAIRS[package]
    return dict(channel=channel(), tree_cls=tree)


@pytest.mark.parametrize("rows", [1 << 22, 1 << 3])
def test_sha_tree_matches_committed_tree(rows, monkeypatch):
    """Root, every level, a decommitment and a pair decommitment of the
    SHA-256 tree at mixed log sizes (below and above the native kernels'
    thresholds), hashed where its columns lie (the plain version here) in
    one block and in blocks of 2**3 leaf rows.  The tree is one
    `tree.commit` span holding, for each level of each block (and each level
    above the blocks), a `sha256.level` span followed by the `to_host` span
    of its digests' copy (the spans' entries and exits recorded in order)."""
    opened = []

    class Recorded:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            opened.append(("enter", self.name))

        def __exit__(self, *exc):
            opened.append(("exit", self.name))

    monkeypatch.setattr(t_commit, "SHA_ROWS", rows)
    monkeypatch.setattr(t_commit, "span", Recorded)
    columns = {10: _rand(1, 5, 1 << 10), 8: _rand(2, 3, 1 << 8), 5: _rand(3, 9, 1 << 5), 2: _rand(4, 2, 4)}
    ref = Sha256CommittedTree({L: c.astype(np.uint32) for L, c in columns.items()})
    tree = t_commit.Sha256DeviceTree({L: torch.from_numpy(c) for L, c in columns.items()})
    assert len(tree.levels) == len(ref.levels) == 11
    for got, want in zip(tree.levels, ref.levels):
        assert got.dtype == want.dtype == np.uint32 and np.array_equal(got, want)
    assert tree.root.dtype == np.uint32 and np.array_equal(tree.root, ref.root)
    block_log = min(10, rows.bit_length() - 1)
    n_levels = (1 << (10 - block_log)) * (block_log + 1) + 10 - block_log
    level = [("enter", "sha256.level"), ("exit", "sha256.level"), ("enter", "to_host"), ("exit", "to_host")]
    assert opened == [("enter", "tree.commit")] + level * n_levels + [("exit", "tree.commit")]
    queries = [int(v) for v in np.random.default_rng(5).integers(0, 1 << 10, 13)]
    vals, dec = tree.decommit(queries)
    ref_vals, ref_dec = ref.decommit(queries)
    assert vals.dtype == np.uint32 and np.array_equal(vals, ref_vals)
    assert np.array_equal(dec.hash_witness, ref_dec.hash_witness)
    pair = t_fri_host.decommit_pair(tree, queries)
    assert np.array_equal(pair.hash_witness, r_fri.decommit_pair(ref, queries).hash_witness)


@pytest.mark.parametrize("name", ["poseidon31", "sha256"])
def test_prove_np_matches_host_prove_np(name, monkeypatch):
    """The port's prove_np on the CPU against the JAX host prove_np, in the
    bytes of each flavour's artifacts, and the port's verifier accepts it
    (verify_batch_np, or the Sha256MerkleChannel host verifier)."""
    if name == "sha256":
        # several quotient chunks per first-layer group
        monkeypatch.setattr(t_quot, "CHUNK", 1 << 5)
    stages = []
    got = t_prove_np(_np_trace(), T_NP_CONFIG, progress=stages.append, device="cpu", **_flavour(name, "port"))
    ref = r_prove_np(_np_trace(), NP_CONFIG, **_flavour(name, "reference"))
    mode = "m31x8" if name == "poseidon31" else "bytes32"
    assert r_ser_np(ref, mode) == t_ser_np(got, mode)
    assert got.total_sum.dtype == np.uint32 and np.asarray(got.stark_proof.commitments).dtype == np.uint32
    assert stages[-1] == "decommitments gathered"
    if name == "poseidon31":
        spec = NoPoseidonVerifierSpec.for_rows(got.log_size, got.config)
        pa = hints.prepare(spec, [got], arrays_fn=from_proofs_np, transcript_fn=transcript_host.run_transcript_np)
        checks = verify_batch_np(spec, to_torch(pa, "cpu"), INPUTS_RECURSIVE)
    else:
        checks = t_vh.verify_sha256np_host(got, INPUTS_RECURSIVE)
    assert all(bool(v.all()) for v in checks.values()), [k for k, v in checks.items() if not v.all()]


def test_prove_np_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError):
        t_prove_np(_np_trace(), T_NP_CONFIG, device="cpu", channel=RChannel(), tree_cls=t_commit.Sha256DeviceTree)
    with pytest.raises(NotImplementedError):
        t_prove_np(_np_trace(), T_NP_CONFIG, device="cpu", channel=TChannel())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            t_prove_np(_np_trace(), T_NP_CONFIG, device="cuda")


def test_last_layer_miniature_matches_reference(monkeypatch):
    """tests/test_sha256_flavor.py:130 on both packages: a Sha256Poseidon31
    proof of the demo circuit, the last-layer circuit over it
    (flagship.last_layer_trace), proved in the Sha256MerkleChannel flavour
    at a light config; the bytes equal, and the port's host verifier accepts
    it with the circuit's public inputs."""
    monkeypatch.setenv("RSTPU_DEVICE_PROVER", "0")
    inner = t_prove_sha256p31(flagship.demo_trace(), T_CONFIG, device="cpu")
    r_inner = r_prove_sha256p31(flagship.demo_trace(), CONFIG)
    trace, config, inputs = flagship.last_layer_trace(inner)
    assert config == flagship.LAST_LAYER_CONFIG
    assert (config.pow_bits, config.fri_config.log_last_layer_degree_bound,
            config.fri_config.log_blowup_factor, config.fri_config.n_queries) == (28, 0, 9, 8)
    r_cs, _ = r_build_last(
        r_inner, list(flagship.CHAIN_INPUTS),
        transcript_fn=lambda s, pa: r_vs.run_transcript_sha256p31(s, r_inner),
        hash_node_fn=r_sha_merkle.hash_node,
    )
    assert inputs == tuple((i + 1, tuple(int(x) for x in r_cs.value(i + 1))) for i in range(r_cs.num_input))
    got = t_prove_np(trace, T_CONFIG, device="cpu", **_flavour("sha256", "port"))
    ref = r_prove_np(r_cs.generate_trace(), CONFIG, **_flavour("sha256", "reference"))
    assert flagship.proof_bytes(got) == r_ser_np(ref, "bytes32")
    assert t_vh.verify_sha256np_host(got, inputs)["ok"].all()


def _recursion_chain_module():
    path = os.path.join(REPO, "examples", "recursion_chain.py")
    spec = importlib.util.spec_from_file_location("_recursion_chain", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _config_fields(config):
    f = config.fri_config
    return (config.pow_bits, f.log_last_layer_degree_bound, f.log_blowup_factor, f.n_queries)


def test_chain_levels_and_presets_match_recursion_chain():
    ref = _recursion_chain_module()
    assert list(flagship.PRESETS) == list(ref.PRESETS)
    for name, config in ref.PRESETS.items():
        assert _config_fields(flagship.PRESETS[name]) == _config_fields(config), name
    assert sorted(flagship.CHAIN_LEVELS) == list(range(1, len(ref.LEVELS) + 1))
    for level, (inp, mult, out, preset) in enumerate(ref.LEVELS, start=1):
        got = flagship.CHAIN_LEVELS[level]
        assert got[:3] == (inp, mult, out) and got[3] is flagship.PRESETS[preset], level
    # recursion_chain.main proves level 14 in the SHA-256 flavour
    assert flagship.SHA_LEVEL == len(ref.LEVELS) == 14


def test_chain_artifact_reader_matches_committed_files():
    """Every committed file of examples/data hashes to the digest the reader
    gives for it (the six files the repo holds), and proof_bytes of each
    committed proof is its .bin: m31x8 for levels 1 and 2, bytes32 for
    level 14 and the bitcoin proof."""
    digests = flagship.chain_artifact_sha256()
    assert len(digests) == 30
    names = [level[2] for level in flagship.CHAIN_LEVELS.values()] + [flagship.LAST_LAYER_ARTIFACT]
    assert sorted(digests) == sorted(f"{n}.{ext}" for n in names for ext in ("bin", "pkl"))
    files = sorted(os.listdir(flagship.CHAIN_DATA))
    assert files == ["bitcoin_proof.bin", "bitcoin_proof.pkl", "level1-5.pkl", "level14-1.bin",
                     "level14-1.pkl", "level2-1.pkl"]
    for name in files:
        with open(os.path.join(flagship.CHAIN_DATA, name), "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == digests[name], name
    for name in ("level1-5", "level2-1", "level14-1", "bitcoin_proof"):
        data = flagship.proof_bytes(flagship.load_artifact(os.path.join(flagship.CHAIN_DATA, f"{name}.pkl")))
        assert hashlib.sha256(data).hexdigest() == flagship.expected_sha256(name), name
    assert flagship.expected_sha256("level3-1").startswith("642d38ee")


def test_chain_tool_reads_its_own_proofs(tmp_path):
    """Level 3 starts from the committed level2-1.pkl; a later start reads
    the tool's own proof of the level before, and refuses without it."""
    assert [chain.level_name(n) for n in (3, 13, 14, 15)] == ["level3-1", "level13-1", "level14-1", "bitcoin_proof"]
    assert chain.input_proof(3, str(tmp_path)) is None
    with pytest.raises(SystemExit, match="level13-1.pkl"):
        chain.input_proof(14, str(tmp_path))
    level14 = flagship.sha_artifact("level14")
    with open(tmp_path / "level14-1.pkl", "wb") as f:
        pickle.dump(level14, f)
    got = chain.input_proof(chain.LAST, str(tmp_path))
    assert flagship.proof_bytes(got) == flagship.proof_bytes(level14)


def test_chain_provers_never_import_jax():
    """prove_np and prove_np_streamed in the Sha256MerkleChannel flavour,
    prove_sha256p31 and the chain tool's tables, with jax and the JAX
    package refused."""
    run_blocked(
        "from recursive_stwo_tpu_torch.cs.system import PlonkWithoutPoseidonCS\n"
        "from recursive_stwo_tpu_torch.gadgets.fields import QM31Var\n"
        "from recursive_stwo_tpu_torch.models import flagship\n"
        "from recursive_stwo_tpu_torch.proof.containers import FriConfig, PcsConfig\n"
        "from recursive_stwo_tpu_torch.prover.commit import Sha256DeviceTree\n"
        "from recursive_stwo_tpu_torch.prover.prove_np import prove_np\n"
        "from recursive_stwo_tpu_torch.prover.prove_sha256 import Sha256ProverChannel, prove_sha256p31\n"
        "from recursive_stwo_tpu_torch.tools import chain\n"
        "from recursive_stwo_tpu_torch.verifier import verify_sha256_host as vh\n"
        "cs = PlonkWithoutPoseidonCS()\n"
        "x = QM31Var.new_witness(cs, (5, 6, 7, 8))\n"
        "(x * x).equalverify(x * x)\n"
        "cs.pad(); cs.check_arithmetics(); cs.populate_logup_arguments()\n"
        "config = PcsConfig(5, FriConfig(1, 2, 8))\n"
        "out = prove_np(cs.generate_trace(), config, device='cpu', channel=Sha256ProverChannel(),\n"
        "               tree_cls=Sha256DeviceTree)\n"
        "assert vh.verify_sha256np_host(out, flagship.CHAIN_INPUTS)['ok'].all()\n"
        "from recursive_stwo_tpu_torch.prover.stream import prove_np_streamed\n"
        "st = prove_np_streamed(cs.generate_trace(), config, device='cpu', channel=Sha256ProverChannel(),\n"
        "                       tree_cls=Sha256DeviceTree, chunk_log=6, cutoff=3)\n"
        "assert flagship.proof_bytes(st) == flagship.proof_bytes(out)\n"
        "p31 = prove_sha256p31(flagship.demo_trace(), config, device='cpu')\n"
        "assert vh.verify_sha256p31_host(p31, flagship.CHAIN_INPUTS)['ok'].all()\n"
        "assert chain.level_name(chain.LAST) == 'bitcoin_proof'\n"
        "assert flagship.expected_sha256('level14-1').startswith('97384736')\n"
    )
