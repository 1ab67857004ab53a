"""The port's prover (recursive_stwo_tpu_torch/prover) against the JAX
package's host prover, module by module and as a whole, on the CPU at
tolerance 0.  Inputs are seeded numpy; the whole-slice proofs are compared
as m31x8 bytes, the serialisation of the chain artifacts."""

import io
from functools import lru_cache

import numpy as np
import pytest
import torch

from recursive_stwo_tpu.core import circle as ccircle
from recursive_stwo_tpu.proof.containers import FriConfig, PcsConfig
from recursive_stwo_tpu.prover import air
from recursive_stwo_tpu.prover import circle_fft as r_fft
from recursive_stwo_tpu.prover import prove as r_prove
from recursive_stwo_tpu.prover.commit import CommittedTree
from recursive_stwo_tpu.recursion import composition as r_comp
from recursive_stwo_tpu.utils import native
from recursive_stwo_tpu.verifier import hints
from recursive_stwo_tpu.verifier.spec import VerifierSpec
from recursive_stwo_tpu_torch.models import flagship
from recursive_stwo_tpu_torch.prover import channel as t_channel
from recursive_stwo_tpu_torch.prover import circle_fft as t_fft
from recursive_stwo_tpu_torch.prover import commit as t_commit
from recursive_stwo_tpu_torch.prover import composition as t_comp
from recursive_stwo_tpu_torch.prover import quotients as t_quot
from recursive_stwo_tpu_torch.prover.interaction import interaction_columns
from recursive_stwo_tpu_torch.prover.prove import prove as t_prove
from recursive_stwo_tpu_torch.prover.sample import sample
from recursive_stwo_tpu_torch.verifier import composition as vcomp
from recursive_stwo_tpu_torch.verifier import verify as t_verify
from recursive_stwo_tpu_torch.verifier.arrays import to_torch
from test_torch_verify import run_blocked

P = 2**31 - 1
# sha256 of chain level 1's m31x8 bytes (docs/chain_artifacts.txt)
LEVEL1_SHA256 = "a51ea3f3d96636750c573b2d46846d9f9e47ecb955fc510c63cec1f0c76be49b"
CONFIGS = {
    "fri-1-3-9": PcsConfig(pow_bits=5, fri_config=FriConfig(1, 3, 9)),
    "fri-0-3-8": PcsConfig(pow_bits=5, fri_config=FriConfig(0, 3, 8)),
}


def _rand(seed, *shape):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.int64)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@lru_cache(maxsize=None)
def _trace():
    return flagship.demo_trace()


@pytest.mark.parametrize("log_size,cols", [(6, 3), (10, 10)])
def test_circle_fft_matches_host(log_size, cols):
    vals = _rand(log_size, cols, 1 << log_size)
    coeffs = r_fft.interpolate(vals.astype(np.uint32))
    assert np.array_equal(t_fft.interpolate(_t(vals)).numpy(), coeffs)
    assert np.array_equal(t_fft.evaluate(_t(coeffs)).numpy(), r_fft.evaluate(coeffs))
    lde = r_fft.evaluate_lde(vals.astype(np.uint32), log_size + 2)
    assert np.array_equal(t_fft.lde(t_fft.interpolate(_t(vals)), log_size + 2).numpy(), lde)


@pytest.mark.parametrize("rows", [1 << 22, 1 << 7])
def test_commit_matches_committed_tree(rows):
    # the mixed sizes of tests/test_device_prover.py:43-51; each level also
    # hashed in blocks of `rows` rows, its columns as views, as a streamed
    # tree hashes a chunk
    columns = {13: _rand(1, 5, 1 << 13), 9: _rand(2, 3, 1 << 9), 5: _rand(3, 9, 1 << 5)}
    ref = CommittedTree({L: c.astype(np.uint32) for L, c in columns.items()})
    tree = t_commit.DeviceTree({L: _t(c) for L, c in columns.items()})
    assert len(tree.levels) == len(ref.levels) == 14
    for got, want in zip(tree.levels, ref.levels):
        assert np.array_equal(got.numpy(), want)
    for k, L in enumerate(range(13, -1, -1)):
        cols = None if L not in columns else _t(columns[L])
        children = None if k == 0 else tree.levels[k - 1]
        blocks = [t_commit._level(None if children is None else children[2 * s : 2 * min(s + rows, 1 << L)],
                                  None if cols is None else cols[:, s : s + rows], min(rows, (1 << L) - s))
                  for s in range(0, 1 << L, rows)]
        assert np.array_equal(torch.cat(blocks).numpy(), ref.levels[k])
    assert np.array_equal(tree.root, ref.root) and tree.root.dtype == np.uint32
    queries = [int(v) for v in np.random.default_rng(4).integers(0, 1 << 13, 11)]
    vals, dec = tree.decommit(queries)
    ref_vals, ref_dec = ref.decommit(queries)
    assert np.array_equal(vals, ref_vals) and np.array_equal(dec.hash_witness, ref_dec.hash_witness)


@pytest.mark.parametrize("log_size", [0, 5, 12])
def test_sample_matches_host(log_size):
    coeffs = _rand(log_size + 10, 7, 1 << log_size)
    rng = np.random.default_rng(log_size)
    p4 = tuple(tuple(int(x) for x in rng.integers(0, P, 4)) for _ in range(2))
    want = r_prove._sample_columns_host(coeffs.astype(np.uint32), r_prove._basis_at_point(log_size, p4))
    got = sample(_t(coeffs), r_prove._factors_at_point(log_size, p4))
    assert got.dtype == np.uint32 and np.array_equal(got, want)


@pytest.mark.parametrize("table", ["plonk", "poseidon"])
def test_interaction_columns_match_host(table):
    trace = _trace()
    if table == "plonk":
        pre, tr = air.plonk_columns(trace)
        ref_fn, fn = r_comp.evaluate_plonk, vcomp.evaluate_plonk
    else:
        pre, tr, _ = air.poseidon_columns(trace)
        ref_fn, fn = r_comp.evaluate_poseidon, vcomp.evaluate_poseidon
    rng = np.random.default_rng(11)
    z4, alpha4 = (rng.integers(0, P, 4).astype(np.uint32) for _ in range(2))
    want_cols, want_total = air.interaction_columns(pre, tr, z4, alpha4, ref_fn)
    lookup = (t_comp.qm31_scalar(z4), t_comp.qm31_scalar(alpha4))
    cols, total = interaction_columns(_t(pre), _t(tr), lookup, fn)
    assert cols.shape == want_cols.shape == (8, pre.shape[1])
    assert np.array_equal(cols.numpy(), want_cols)
    assert np.array_equal(total, np.asarray(want_total, np.uint32))


@pytest.mark.parametrize("dom_log,trace_log", [(6, 5), (9, 6), (11, 8)])
def test_point_sub_step_perm_matches_host(dom_log, trace_log):
    step = ccircle.Coset.odds(trace_log).step_index
    assert np.array_equal(
        t_comp.point_sub_step_perm(dom_log, step), r_prove._point_sub_step_perm(dom_log, step)
    )


@pytest.mark.parametrize("pow_bits,block_log", [(8, 4), (10, 6), (12, 6), (8, 12)])
def test_grind_device_matches_native_scan(pow_bits, block_log):
    digest = _rand(pow_bits, 8).astype(np.uint32)
    nonce = t_channel.grind_device(digest, pow_bits, block_log=block_log, device="cpu")
    assert nonce == native.grind(digest, pow_bits)
    # the first three cases find their nonce past the first block, the last inside it
    assert (nonce >= 1 << block_log) == (block_log < 12)


def _assert_same_proof(got, want):
    assert flagship.proof_bytes(got) == flagship.proof_bytes(want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prove_matches_host_prove(name, monkeypatch):
    if name == "fri-0-3-8":
        # cover the chunked quotient loop: several chunks per first-layer group
        monkeypatch.setattr(t_quot, "CHUNK", 1 << 6)
    config = CONFIGS[name]
    stages = []
    proof = t_prove(_trace(), config, progress=stages.append, device="cpu")
    _assert_same_proof(proof, r_prove.prove(_trace(), config))
    assert stages[-1] == "decommitments gathered"
    spec = VerifierSpec.from_proof(proof)
    checks = t_verify.verify_batch(spec, to_torch(hints.prepare(spec, [proof]), "cpu"), flagship.CHAIN_INPUTS)
    assert all(bool(v.all()) for v in checks.values()), [k for k, v in checks.items() if not v.all()]


def test_prove_refuses_what_is_not_ported():
    """A channel of another package and a flavour's tree without its channel
    raise; so does a missing card."""
    from recursive_stwo_tpu.prover.channel import PoseidonChannel

    config = CONFIGS["fri-1-3-9"]
    with pytest.raises(NotImplementedError):
        t_prove(_trace(), config, device="cpu", tree_cls=t_commit.Sha256DeviceTree)
    with pytest.raises(NotImplementedError):
        t_prove(_trace(), config, device="cpu", channel=PoseidonChannel())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            t_prove(_trace(), config, device="cuda")


def test_prover_never_imports_jax():
    """With jax and the JAX package refused: the demo circuit is proved on
    the CPU, resident and streamed, and chain level 1's artifact loads into
    the port's containers and serialises to the bytes
    docs/chain_artifacts.txt names."""
    run_blocked(
        "import hashlib, os\n"
        "from recursive_stwo_tpu_torch.models import flagship\n"
        "from recursive_stwo_tpu_torch.proof.containers import FriConfig, PcsConfig\n"
        "from recursive_stwo_tpu_torch.prover.prove import prove\n"
        "proof = prove(flagship.demo_trace(), PcsConfig(5, FriConfig(1, 3, 9)), device='cpu')\n"
        "assert len(flagship.proof_bytes(proof)) > 0\n"
        "from recursive_stwo_tpu_torch.prover.stream import prove_streamed\n"
        "streamed = prove_streamed(flagship.demo_trace(), PcsConfig(5, FriConfig(1, 3, 9)), device='cpu',\n"
        "                          chunk_log=9, cutoff=5)\n"
        "assert flagship.proof_bytes(streamed) == flagship.proof_bytes(proof)\n"
        "art = flagship.load_artifact(os.path.join(flagship.CHAIN_DATA, 'level1-5.pkl'))\n"
        "assert type(art).__module__ == 'recursive_stwo_tpu_torch.proof.containers'\n"
        "digest = hashlib.sha256(flagship.proof_bytes(art)).hexdigest()\n"
        f"assert digest == '{LEVEL1_SHA256}', digest\n"
    )


def test_artifact_loader_refuses_other_names():
    """A pickle naming a JAX-package class outside the proof containers (a
    GLOBAL opcode for recursive_stwo_tpu.prover.prove.prove) is refused."""
    import pickle

    data = b"crecursive_stwo_tpu.prover.prove\nprove\n."
    with pytest.raises(pickle.UnpicklingError, match="no copy"):
        flagship._ArtifactUnpickler(io.BytesIO(data)).load()
