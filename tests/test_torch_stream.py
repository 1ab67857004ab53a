"""The port's streamed prover (recursive_stwo_tpu_torch/prover/stream.py) and
its SHA-256 tree level against the JAX package on the CPU, at tolerance 0.

Inputs are seeded numpy.  The SHA-256 plain version is held to the JAX
package's numpy `sha256_words` and to hashlib, `sha256_level` to its
`sha256_merkle` level functions; the tile geometry (prover/tiles.py) to
`recursive_stwo_tpu.prover.stream`'s numpy functions, and the FRI folds on
tile points to its host folds; `StreamedTree` in
both flavours to the host `CommittedTree` / `Sha256CommittedTree` (root,
decommitment, pair decommitment); the streamed provers in both flavours to
the host `prove` / `prove_np`, as the bytes of each flavour's artifacts.
Small chunks and cutoffs (chunk_log 8-10, cutoff 4-5) make every tree
several chunks of several tiles, as tests/test_stream_prover.py does for the
JAX package's streamed prover."""

import hashlib

import numpy as np
import pytest
import torch

from recursive_stwo_tpu.core import m31 as r_m31
from recursive_stwo_tpu.core.qm31 import QM31 as RQM31
from recursive_stwo_tpu.core import sha256 as r_sha
from recursive_stwo_tpu.proof.containers import FriConfig, PcsConfig
from recursive_stwo_tpu.proof.serialize import serialize_plonk_with_poseidon_proof as r_ser
from recursive_stwo_tpu.proof.serialize import serialize_plonk_without_poseidon_proof as r_ser_np
from recursive_stwo_tpu.prover import circle_fft as r_fft
from recursive_stwo_tpu.prover import commit as r_commit
from recursive_stwo_tpu.prover import fri as r_fri
from recursive_stwo_tpu.prover import stream as r_stream
from recursive_stwo_tpu.prover.prove import prove as r_prove
from recursive_stwo_tpu.prover.prove_np import prove_np as r_prove_np
from recursive_stwo_tpu.prover.prove_sha256 import Sha256ProverChannel as RChannel
from recursive_stwo_tpu.verifier import hints
from recursive_stwo_tpu.verifier import sha256_merkle as r_merkle
from recursive_stwo_tpu_torch.core import sha256 as t_sha
from recursive_stwo_tpu_torch.cs import scalar
from recursive_stwo_tpu_torch.cs.system import PlonkWithoutPoseidonCS
from recursive_stwo_tpu_torch.gadgets.fields import QM31Var
from recursive_stwo_tpu_torch.models import flagship
from recursive_stwo_tpu_torch.proof.containers import FriConfig as TFriConfig
from recursive_stwo_tpu_torch.proof.containers import PcsConfig as TPcsConfig
from recursive_stwo_tpu_torch.proof.serialize import serialize_plonk_without_poseidon_proof as t_ser_np
from recursive_stwo_tpu_torch.prover import fri as t_fri
from recursive_stwo_tpu_torch.prover import fri_host as t_fri_host
from recursive_stwo_tpu_torch.prover import stream as t_stream
from recursive_stwo_tpu_torch.prover import tiles as t_tiles
from recursive_stwo_tpu_torch.prover.commit import Sha256DeviceTree
from recursive_stwo_tpu_torch.prover.composition import qm31_scalar
from recursive_stwo_tpu_torch.prover.prove_sha256 import Sha256ProverChannel as TChannel
from recursive_stwo_tpu_torch.verifier import verify as t_verify
from recursive_stwo_tpu_torch.verifier import verify_sha256_host as t_vh
from recursive_stwo_tpu_torch.verifier.arrays import to_torch
from recursive_stwo_tpu_torch.verifier.spec import VerifierSpec

P = 2**31 - 1
# tests/test_stream_prover.py's light config and chunking: blowup 3, every
# tree of the demo circuit several chunks of 2**9 rows
CONFIG = PcsConfig(pow_bits=5, fri_config=FriConfig(1, 3, 9))
T_CONFIG = TPcsConfig(pow_bits=5, fri_config=TFriConfig(1, 3, 9))
STREAM = dict(chunk_log=9, cutoff=5)
# the JAX streamed tests' (T, b) tile cases
TILE_CASES = [(10, 6), (12, 9), (9, 9)]


def _rng(seed):
    return np.random.default_rng(seed)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int64))


# ---- SHA-256: the plain version and the tree level ---------------------------


@pytest.mark.parametrize("k", [1, 8, 13, 14, 16, 24, 40])
def test_sha256_plain_matches_numpy_and_hashlib(k):
    """K message words: one block up to K = 13, two from 14 (the padding
    word and two length words no longer fit), three at 40; words of 2**31
    and above, and all ones."""
    words = _rng(k).integers(0, 2**32, (9, k), dtype=np.uint64).astype(np.uint32)
    words[0] = 0xFFFFFFFF
    words[1] = 0x80000000
    got = t_sha.sha256_words_plain(_t(words))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), r_sha.sha256_words(words).astype(np.int64))
    for row, digest in zip(words, got.numpy()):
        want = np.frombuffer(hashlib.sha256(row.astype(">u4").tobytes()).digest(), ">u4")
        assert np.array_equal(digest, want.astype(np.int64))
    state = _rng(k + 1).integers(0, 2**32, (9, 8), dtype=np.uint64).astype(np.uint32)
    block = _rng(k + 2).integers(0, 2**32, (9, 16), dtype=np.uint64).astype(np.uint32)
    assert np.array_equal(t_sha.compress_plain(_t(state), _t(block)).numpy(),
                          r_sha.compress(state, block).astype(np.int64))


@pytest.mark.parametrize("n", [1, 7, 129])
@pytest.mark.parametrize("n_cols", [0, 1, 13, 40])
def test_sha256_level_matches_merkle_levels(n, n_cols):
    """sha256_level on the CPU (the plain version) against the JAX package's
    hash_leaf_level / hash_node_level, with and without columns (129 rows
    reach its native kernels' thresholds)."""
    rng = _rng(100 * n + n_cols)
    cols = rng.integers(0, P, (n_cols, n), dtype=np.uint32)
    children = rng.integers(0, 2**32, (2 * n, 8), dtype=np.uint64).astype(np.uint32)
    if n_cols:
        got = t_sha.sha256_level(None, _t(cols))
        assert np.array_equal(got.numpy(), r_merkle.hash_leaf_level(cols).astype(np.int64))
    got = t_sha.sha256_level(_t(children), _t(cols) if n_cols else None)
    want = r_merkle.hash_node_level(children, cols if n_cols else None)
    assert np.array_equal(got.numpy(), want.astype(np.int64))


# ---- tile geometry -----------------------------------------------------------


@pytest.mark.parametrize("T,b", TILE_CASES)
def test_tile_geometry_matches_reference(T, b):
    """The host tables equal the JAX package's, and every tile's evaluation
    equals the full LDE (the chunked evaluation is a restriction of it)."""
    for name in ("circle_tile_table", "circle_tile_bases", "line_tile_table", "line_tile_bases"):
        for got, want in zip(getattr(t_tiles, name)(T, b), getattr(r_stream, name)(T, b)):
            assert np.array_equal(got, want), name
    assert np.array_equal(t_tiles.odd_mask(b), r_stream._odd_mask(b))
    coeffs = _rng(T).integers(0, P, (3, 1 << b), dtype=np.uint32)
    full = r_fft.evaluate(r_fft.extend(coeffs, T))
    src = t_stream.CoeffSource(_t(coeffs), T)
    n_tiles = 1 << (T - b)
    cx, cy = t_tiles.circle_tiles(T, b, 0, n_tiles, "cpu").points()
    vals = src.values(0, n_tiles)
    assert np.array_equal(vals.numpy(), full.astype(np.int64))
    # the reference's own tile evaluation on the same points
    bx, by = r_stream.circle_tile_bases(T, b)
    tx, ty = r_stream.circle_tile_table(T, b)
    rx, ry = r_stream._tile_points(bx, by, tx, ty, r_stream._odd_mask(b))
    assert np.array_equal(cx.numpy(), rx.astype(np.int64)) and np.array_equal(cy.numpy(), ry.astype(np.int64))
    # rows across a tile boundary
    lo, hi = (1 << b) - 3, min(1 << T, (1 << b) + 5)
    assert np.array_equal(src.rows(lo, hi).numpy(), full[:, lo:hi].astype(np.int64))


@pytest.mark.parametrize("T,b", [(9, 6), (10, 7)])
def test_tile_folds_match_reference(T, b, monkeypatch):
    """1/x and 1/y from tile points equal the JAX package's fold tables, and
    prover/fri.py's folds, on tiles of 2**b and of its own size, equal the
    JAX package's host folds."""
    gn = _rng(T).integers(0, P, (4, 1 << T), dtype=np.uint32)
    g = _t(gn)
    alpha4 = (5, 6, 7, 8)
    alpha = qm31_scalar(alpha4)
    tx, ty, _ = t_tiles.tile_consts(T, b, True, torch.device("cpu"))
    bx, by = t_tiles.tile_bases(T, b, 0, 1 << (T - b), True, "cpu")
    cx, _ = t_tiles.tile_points(bx, by, tx, ty, None)
    xinv = r_m31.inv(cx.numpy().astype(np.uint32)[:, 0::2].reshape(-1))
    assert np.array_equal(xinv, r_fri.line_fold_xinv(T))
    tx, ty, odd = t_tiles.tile_consts(T, b, False, torch.device("cpu"))
    bx, by = t_tiles.tile_bases(T, b, 0, 1 << (T - b), False, "cpu")
    _, cy = t_tiles.tile_points(bx, by, tx, ty, odd)
    yinv = r_m31.inv(cy.numpy().astype(np.uint32)[:, 0::2].reshape(-1))
    assert np.array_equal(yinv, r_fri.circle_fold_yinv(T))
    want_line = np.stack(list(r_fri.fold_line(RQM31(*gn), alpha4, T))).astype(np.int64)
    want_circle = np.stack(list(r_fri.fold_circle(RQM31(*gn), alpha4))).astype(np.int64)
    for tile_log in (t_fri.TILE_LOG, b):  # one tile, then several
        monkeypatch.setattr(t_fri, "TILE_LOG", tile_log)
        assert np.array_equal(t_fri.fold_line(g, alpha, T).numpy(), want_line), tile_log
        assert np.array_equal(t_fri.fold_circle(g, alpha, T).numpy(), want_circle), tile_log


# ---- the streamed tree ---------------------------------------------------------


def _tree_pair(sources_spec, seed, flavor, **stream):
    """The same columns as the JAX host tree and as a StreamedTree: "eval"
    sources from base coefficients (blowup given), "res" ones resident."""
    rng = _rng(seed)
    columns, sources = {}, {}
    for L, n_cols, kind, blowup in sources_spec:
        if kind == "eval":
            coeffs = r_fft.interpolate(rng.integers(0, P, (n_cols, 1 << (L - blowup)), dtype=np.uint32))
            columns[L] = r_fft.evaluate(r_fft.extend(coeffs, L))
            sources[L] = t_stream.CoeffSource(_t(coeffs), L)
        else:
            columns[L] = rng.integers(0, P, (n_cols, 1 << L), dtype=np.uint32)
            sources[L] = t_stream.ResidentSource(_t(columns[L]))
    host = (r_commit.Sha256CommittedTree if flavor == "sha256" else r_commit.CommittedTree)(columns)
    return host, t_stream.StreamedTree(sources, flavor=flavor, **stream)


# tests/test_stream_prover.py:91-128: mixed eval/res sources, a single
# resident level, and the pair-decommit tree
TREE_CASES = {
    "mixed": ([(12, 5, "eval", 3), (11, 7, "eval", 3), (10, 4, "res", 0)], dict(chunk_log=10, cutoff=5)),
    "single": ([(11, 4, "res", 0)], dict(chunk_log=8, cutoff=4)),
    "pair": ([(11, 4, "res", 0), (10, 4, "res", 0)], dict(chunk_log=8, cutoff=4)),
}


@pytest.mark.parametrize("flavor", ["p31", "sha256"])
@pytest.mark.parametrize("case", list(TREE_CASES))
def test_streamed_tree_matches_committed_tree(case, flavor):
    spec, stream = TREE_CASES[case]
    host, tree = _tree_pair(spec, len(case), flavor, **stream)
    assert tree.C < tree.max_log and tree.K < tree.max_log  # several chunks, spans above K
    assert np.array_equal(tree.root, host.root)
    queries = sorted(_rng(7).integers(0, 1 << tree.max_log, size=9).tolist())
    vals, dec = tree.decommit(queries)
    ref_vals, ref_dec = host.decommit(queries)
    assert vals.dtype == np.uint32 and np.array_equal(vals, ref_vals)
    assert np.array_equal(dec.hash_witness, ref_dec.hash_witness)
    pair = t_fri_host.decommit_pair(tree, queries)
    assert np.array_equal(pair.hash_witness, r_fri.decommit_pair(host, queries).hash_witness)


def test_span_summit_mismatch_raises():
    """A span recomputed for a decommitment is checked against its stored
    summit: a corrupted summit makes the span raise."""
    _, tree = _tree_pair(TREE_CASES["mixed"][0], 3, "p31", **TREE_CASES["mixed"][1])
    tree.level_rows(0, [0])  # span 0 checks out
    span = 1 << (tree.max_log - tree.K)
    tree._tops[0][1, 0] ^= 1
    with pytest.raises(RuntimeError, match="summit"):
        tree.level_rows(0, [span + 2])


# ---- the streamed provers -------------------------------------------------------


@pytest.mark.parametrize("flavor", ["p31", "sha256"])
def test_prove_streamed_matches_host_prove(flavor):
    """prove_streamed on the CPU against the JAX host prove with the same
    channel and tree flavour, in the bytes of each flavour's artifacts; the
    port's verifier accepts it (verify_batch, or the Sha256Poseidon31 host
    verifier)."""
    trace = flagship.demo_trace()
    stages = []
    if flavor == "p31":
        got = t_stream.prove_streamed(trace, T_CONFIG, progress=stages.append, device="cpu", **STREAM)
        ref = r_prove(trace, CONFIG)
        assert flagship.proof_bytes(got) == r_ser(ref, "m31x8")
        spec = VerifierSpec.from_proof(got)
        checks = t_verify.verify_batch(spec, to_torch(hints.prepare(spec, [got]), "cpu"), flagship.CHAIN_INPUTS)
    else:
        got = t_stream.prove_streamed(trace, T_CONFIG, progress=stages.append, device="cpu", channel=TChannel(),
                                      tree_cls=Sha256DeviceTree, **STREAM)
        ref = r_prove(trace, CONFIG, channel=RChannel(), tree_cls=r_commit.Sha256CommittedTree)
        assert flagship.proof_bytes(got) == r_ser(ref, "bytes32")
        checks = t_vh.verify_sha256p31_host(got, flagship.CHAIN_INPUTS)
    assert all(bool(v.all()) for v in checks.values()), [k for k, v in checks.items() if not v.all()]
    assert "quotients at log 13 streamed" in stages and stages[-1] == "decommitments gathered"


def _np_trace():
    """The circuit of tests/test_stream_prover.py:211-222."""
    cs = PlonkWithoutPoseidonCS()
    a = (12345, 678, 91011, 1213)
    av = QM31Var.new_witness(cs, a)
    bv = QM31Var.new_witness(cs, scalar.q_pow(a, 31))
    av.pow(31).equalverify(bv)
    cs.pad()
    cs.check_arithmetics()
    cs.populate_logup_arguments()
    return cs.generate_trace()


@pytest.mark.parametrize("flavor", ["p31", "sha256"])
def test_prove_np_streamed_matches_host_prove_np(flavor):
    trace = _np_trace()
    if flavor == "p31":
        got = t_stream.prove_np_streamed(trace, T_CONFIG, device="cpu", **STREAM)
        ref = r_prove_np(trace, CONFIG)
        mode = "m31x8"
    else:
        got = t_stream.prove_np_streamed(trace, T_CONFIG, device="cpu", channel=TChannel(),
                                         tree_cls=Sha256DeviceTree, **STREAM)
        ref = r_prove_np(trace, CONFIG, channel=RChannel(), tree_cls=r_commit.Sha256CommittedTree)
        mode = "bytes32"
    assert t_ser_np(got, mode) == r_ser_np(ref, mode)
    assert got.total_sum.dtype == np.uint32 and np.asarray(got.stark_proof.commitments).dtype == np.uint32


def test_streamed_provers_refuse_what_is_not_ported():
    trace = flagship.demo_trace()
    with pytest.raises(NotImplementedError):
        t_stream.prove_streamed(trace, T_CONFIG, device="cpu", channel=TChannel())
    with pytest.raises(NotImplementedError):
        t_stream.prove_streamed(trace, T_CONFIG, device="cpu", tree_cls=Sha256DeviceTree)
    with pytest.raises(NotImplementedError):
        t_stream.prove_np_streamed(_np_trace(), T_CONFIG, device="cpu", channel=TChannel())
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        t_stream.prove_streamed(trace, T_CONFIG, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        t_stream.prove_np_streamed(_np_trace(), T_CONFIG, device="cuda")
