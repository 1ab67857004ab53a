"""The provers' FRI fold layers and Poseidon31 Merkle levels of the port
(recursive_stwo_tpu_torch/prover/fri.py `fold_layer_plain`, prover/commit.py
`level_plain` / `commit_levels`, prover/stream.py's `_hash_span`) against the
JAX package on the CPU, at tolerance 0 (every value an M31 residue), and the
host side of their CUDA kernels' wrappers (ops/fri_fold_cuda.py,
ops/merkle_cuda.py).

Inputs are seeded numpy.  The plain fold layer is held to the jitted
`_fold_line_jit` followed by `_join_commit_jit`'s accumulator (and that
jit's tree levels to `commit_levels`), and to the streamed `_line_fold_jit`
/ `_join_fold_jit` on tile bases; a numpy model of the fold kernel's thread
-> (pair, point) map and inverse to `fri_host.line_fold_xinv` /
`circle_fold_yinv`; the plain Merkle levels to `_commit_levels`, and a
streamed tree's spans to `_commit_chunk_jit` (p31).  The kernels themselves
run only on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recursive_stwo_tpu.prover import device_prove as r_dev
from recursive_stwo_tpu.prover import stream as r_stream
from recursive_stwo_tpu_torch.core import m31_host
from recursive_stwo_tpu_torch.core.qm31 import QM31
from recursive_stwo_tpu_torch.cs import scalar
from recursive_stwo_tpu_torch.models import flagship
from recursive_stwo_tpu_torch.ops import fri_fold_cuda, merkle_cuda
from recursive_stwo_tpu_torch.prover import commit as t_commit
from recursive_stwo_tpu_torch.prover import fri as t_fri
from recursive_stwo_tpu_torch.prover import fri_host
from recursive_stwo_tpu_torch.prover import stream as t_stream
from recursive_stwo_tpu_torch.prover.prove import prove as t_prove

P = 2**31 - 1
META = dict(device="meta", dtype=torch.int64)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _np(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def _alpha(rng):
    return tuple(int(v) for v in rng.integers(0, P, 4))


# ---- the fold layer ------------------------------------------------------------


@pytest.mark.parametrize("n", range(1, 13))
@pytest.mark.parametrize("kind", ["line", "line + join", "first"])
def test_fold_layer_plain_matches_jax(n, kind):
    """fold_layer_plain against `_fold_line_jit(n)` then the accumulator of
    `_join_commit_jit(n - 1, join_log, first)`, and that jit's tree levels
    against `commit_levels`, bit for bit."""
    rng = _rng(10 * n + len(kind))
    g = rng.integers(0, P, (4, 1 << n), dtype=np.uint32)
    join = rng.integers(0, P, (4, 1 << n), dtype=np.uint32)
    alpha = _alpha(rng)
    a2 = np.asarray(scalar.q_mul(alpha, alpha), np.uint32)
    a4 = np.asarray(alpha, np.uint32)
    if kind == "first":
        want, levels = r_dev._join_commit_jit(n - 1, n, True)(jnp.zeros((4, 1), jnp.uint32), join, a2, a4)
        got = t_fri.fold_layer_plain(None, _t(join), QM31(*alpha), n)
    else:
        line = r_dev._fold_line_jit(n)(g, a4)
        with_join = kind == "line + join"
        want, levels = r_dev._join_commit_jit(n - 1, n if with_join else None, False)(
            line, join if with_join else jnp.zeros((4, 1), jnp.uint32), a2, a4 if with_join else np.zeros(4, np.uint32))
        got = t_fri.fold_layer_plain(_t(g), _t(join) if with_join else None, QM31(*alpha), n)
    assert np.array_equal(got.numpy(), _np(want))
    assert np.array_equal(t_fri.fold_layer(got, None, QM31(*alpha), n - 1).numpy() if n > 1 else got.numpy(),
                          _np(r_dev._fold_line_jit(n - 1)(want, a4)) if n > 1 else _np(want))
    ours = t_commit.commit_levels({n - 1: got})
    assert len(ours) == len(levels)
    for a, b in zip(ours, levels):
        assert np.array_equal(a.numpy(), _np(b))


@pytest.mark.parametrize("n,b", [(3, 1), (6, 3), (9, 5), (10, 10), (12, 7), (12, 12)])
@pytest.mark.parametrize("kind", ["line", "line + join", "first"])
def test_fold_layer_plain_matches_streamed_jax(n, b, kind):
    """fold_layer_plain against the streamed `_line_fold_jit(n, b)` then
    `_join_fold_jit(n - 1, join_log, first, b)` on tile bases of 2**b
    (b < n: several tiles; b = n: one)."""
    rng = _rng(100 * n + b + len(kind))
    g = rng.integers(0, P, (4, 1 << n), dtype=np.uint32)
    join = rng.integers(0, P, (4, 1 << n), dtype=np.uint32)
    alpha = _alpha(rng)
    a2 = np.asarray(scalar.q_mul(alpha, alpha), np.uint32)
    a4 = np.asarray(alpha, np.uint32)
    cbx, cby = r_stream.circle_tile_bases(n, b)
    lbx, lby = r_stream.line_tile_bases(n, b)
    if kind == "first":
        want = r_stream._join_fold_jit(n - 1, n, True, b)(jnp.zeros((4, 1), jnp.uint32), join, a2, a4,
                                                           jnp.asarray(cbx), jnp.asarray(cby))
        got = t_fri.fold_layer_plain(None, _t(join), QM31(*alpha), n)
    else:
        line = r_stream._line_fold_jit(n, b)(g, a4, jnp.asarray(lbx), jnp.asarray(lby))
        if kind == "line":
            want = line
            got = t_fri.fold_layer_plain(_t(g), None, QM31(*alpha), n)
        else:
            want = r_stream._join_fold_jit(n - 1, n, False, b)(line, join, a2, a4, jnp.asarray(cbx),
                                                                jnp.asarray(cby))
            got = t_fri.fold_layer_plain(_t(g), _t(join), QM31(*alpha), n)
    assert np.array_equal(got.numpy(), _np(want))


def _inv_model(a: np.ndarray) -> np.ndarray:
    """csrc/m31.cuh's inv on uint64 numpy words: its addition chain, each
    product reduced as mul() reduces it (one 2**31 fold, an unsigned
    minimum)."""

    def mul(x, y):
        z = x * y
        r = (z & P) + (z >> 31)
        return np.minimum(r, (r - P) & 0xFFFFFFFF)

    def sqn(x, k):
        for _ in range(k):
            x = mul(x, x)
        return x

    a = a.astype(np.uint64)
    t0 = mul(sqn(a, 2), a)
    t1 = mul(sqn(t0, 1), t0)
    t2 = mul(sqn(t1, 3), t0)
    t3 = mul(sqn(t2, 1), t0)
    t4 = mul(sqn(t3, 8), t3)
    t5 = mul(sqn(t4, 8), t3)
    return mul(sqn(t5, 7), t2)


def _kernel_points(n: int, line: bool) -> np.ndarray:
    """The fold kernel's coordinate of every thread i (csrc/fri_fold.cu
    `coordinate`): position 2i = j 2**b + r, j = i >> (b - 1), k = r / 2 =
    i & (2**(b - 1) - 1), read from ops/fri_fold_cuda.host_table."""
    b = fri_fold_cuda.split_log(n)
    tab = fri_fold_cuda.host_table(n, line).astype(np.uint64)
    tiles, half = 1 << (n - b), 1 << (b - 1)
    assert tab.shape == (2 * tiles + 2 * half,)
    i = np.arange(1 << (n - 1), dtype=np.uint64)
    j, k = i >> np.uint64(b - 1), i & np.uint64(half - 1)
    bx, by = tab[j], tab[tiles + j]
    tx, ty = tab[2 * tiles + k], tab[2 * tiles + half + k]
    if line:
        return (bx * tx % P + P - by * ty % P) % P
    return (bx * ty + by * tx) % P


@pytest.mark.parametrize("n", range(1, 17))
def test_fold_kernel_points_and_inverses_model(n):
    """A numpy model of the fold kernel's thread -> (pair, point) map and its
    inverse (one m31.cuh inv a point, no batching) equals
    fri_host.line_fold_xinv / circle_fold_yinv at every thread."""
    for line, want in ((True, fri_host.line_fold_xinv(n)), (False, fri_host.circle_fold_yinv(n))):
        pts = _kernel_points(n, line)
        assert np.array_equal(_inv_model(pts), want.astype(np.uint64)), (n, line)


def test_fold_kernel_inverse_of_zero_is_zero():
    """The kernel's inverse chain takes 0 to 0, as m31.inv in both packages,
    and every other residue to its inverse."""
    x = np.concatenate([[0, 1, 2, P - 1], _rng(3).integers(1, P, 1000)]).astype(np.uint64)
    got = _inv_model(x)
    assert got[0] == 0
    assert np.array_equal(got, m31_host.inv(x.astype(np.uint32)).astype(np.uint64))
    assert np.all(got[1:] * x[1:] % P == 1)


def test_fold_dispatch_takes_the_plain_version_and_fri_tail_folds_once_a_layer(monkeypatch):
    """On the CPU fold_layer takes fold_layer_plain, never the kernel's
    wrapper, and a proof calls it spec.n_inner_layers + 1 times: the first
    layer's circle fold, then one a layer (the line fold and the next
    layer's join together); the proof's bytes are the CPU run's."""
    calls = []
    plain = t_fri.fold_layer_plain

    def spy(g, join, alpha, log_size):
        calls.append((g is not None, join is not None, log_size))
        return plain(g, join, alpha, log_size)

    def refuse(*a, **k):
        raise AssertionError("the kernel's wrapper was called on the CPU")

    want = flagship.proof_bytes(t_prove(flagship.demo_trace(), flagship.DEMO_CONFIG, device="cpu"))
    monkeypatch.setattr(t_fri, "fold_layer_plain", spy)
    monkeypatch.setattr(fri_fold_cuda, "fold_layer", refuse)
    monkeypatch.setattr(merkle_cuda, "level", refuse)
    proof = t_prove(flagship.demo_trace(), flagship.DEMO_CONFIG, device="cpu")
    assert flagship.proof_bytes(proof) == want
    from recursive_stwo_tpu_torch.verifier.spec import VerifierSpec

    spec = VerifierSpec.from_proof(proof)
    M = spec.max_first_layer_log
    assert len(calls) == spec.n_inner_layers + 1
    assert calls[0] == (False, True, M)
    for i, (line, circle, log) in enumerate(calls[1:]):
        assert (line, log) == (True, M - 1 - i)
        assert circle == (i + 1 < spec.n_inner_layers and log in spec.all_log_sizes)


# ---- the Merkle levels -----------------------------------------------------------


@pytest.mark.parametrize("widths", [(1, 0, 7), (8, 9, 17), (17, 1, 8), (0, 8, 9), (9, 17, 0), (7, 7, 1)])
def test_commit_levels_match_jax(widths):
    """commit_levels (level_plain on the CPU) against the jitted
    `_commit_levels` at mixed sizes, 0, 1, 7, 8, 9 and 17 columns at a level
    (0 at the leaf level: an empty absorb)."""
    rng = _rng(sum(w << (5 * k) for k, w in enumerate(widths)))
    cols = {L: rng.integers(0, P, (w, 1 << L), dtype=np.uint32) for L, w in zip((9, 6, 2), widths)}
    sig = tuple((L, int(c.shape[0])) for L, c in sorted(cols.items(), reverse=True))
    want = r_dev._commit_tree_jit(sig)(*[jnp.asarray(cols[L]) for L, _ in sig])
    got = t_commit.commit_levels({L: _t(c) for L, c in cols.items()})
    assert len(got) == len(want) == 10
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), _np(b))


@pytest.mark.parametrize("n_cols", [0, 1, 7, 8, 9, 17])
def test_level_plain_reads_column_views(n_cols):
    """level_plain on a strided column view (a streamed chunk's `rows`)
    equals it on the same columns made contiguous, at a leaf and a node
    level."""
    rng = _rng(n_cols)
    wide = _t(rng.integers(0, P, (n_cols, 96), dtype=np.uint32))
    view = wide[:, 32:64]
    children = _t(rng.integers(0, P, (64, 8), dtype=np.uint32))
    for ch in (None, children):
        if ch is None and not n_cols:
            continue
        assert torch.equal(t_commit.level_plain(ch, view, 32), t_commit.level_plain(ch, view.contiguous(), 32))


def test_streamed_hash_span_matches_commit_chunk_jit():
    """A streamed Poseidon31 tree's spans (`_hash_span`, resident sources
    read as strided `rows` views, one of them itself a view of a wider
    tensor) against the JAX package's `_commit_chunk_jit` (p31) on the same
    plan, chunk by chunk, and its root against `_commit_levels`."""
    rng = _rng(7)
    widths = {10: 5, 8: 9, 6: 17, 3: 1}
    cols = {L: rng.integers(0, P, (w, 1 << L), dtype=np.uint32) for L, w in widths.items()}
    wide = _t(rng.integers(0, P, (9, 3 << 8), dtype=np.uint32))
    wide[:, 1 << 8 : 2 << 8] = _t(cols[8])
    srcs = {L: t_stream.ResidentSource(wide[:, 1 << 8 : 2 << 8] if L == 8 else _t(c)) for L, c in cols.items()}
    tree = t_stream.StreamedTree(srcs, t_commit.DeviceTree, chunk_log=8, cutoff=4)
    M, C, K = 10, tree.C, tree.K
    assert (C, K) == (8, 3)
    plan = tuple(("res", L, w, 0) for L, w in sorted(widths.items(), reverse=True))
    run = r_stream._commit_chunk_jit(plan, C, K, "p31")
    for j in range(1 << (M - C)):
        args = []
        for _, L, _, _ in plan:
            rows = 1 << (C - (M - L))
            args.append(jnp.asarray(cols[L][:, j * rows : (j + 1) * rows]))
        assert np.array_equal(tree._hash_span(C, j)[0].numpy(), _np(run(*args))), j
    sig = tuple((L, widths[L]) for L in sorted(widths, reverse=True))
    want = r_dev._commit_tree_jit(sig)(*[jnp.asarray(cols[L]) for L, _ in sig])
    assert np.array_equal(tree.root.astype(np.int64), _np(want[-1][0]))


def test_commit_dispatch_takes_the_plain_version(monkeypatch):
    """On the CPU `_level` takes level_plain, never the kernel's wrapper."""

    def refuse(*a, **k):
        raise AssertionError("the kernel's wrapper was called on the CPU")

    monkeypatch.setattr(merkle_cuda, "level", refuse)
    cols = _t(_rng(1).integers(0, P, (3, 16), dtype=np.uint32))
    assert torch.equal(t_commit._level(None, cols, 16), t_commit.level_plain(None, cols, 16))


# ---- the wrappers' limits and bounds ----------------------------------------------


def test_fri_fold_wrapper_limits_raise():
    """Every limit of ops/fri_fold_cuda.py raises ValueError before any
    launch (meta tensors: no memory is touched)."""
    a = QM31(1, 2, 3, 4)
    cases = {
        "no input": (None, None, a, 4),
        "log 0": (torch.empty((4, 1), **META), None, a, 0),
        f"log {fri_fold_cuda.MAX_LOG + 1}": (torch.empty((4, 2 << fri_fold_cuda.MAX_LOG), **META), None, a,
                                              fri_fold_cuda.MAX_LOG + 1),
        "wrong length": (torch.empty((4, 8), **META), None, a, 4),
        "three limbs": (None, torch.empty((3, 16), **META), a, 4),
        "int32": (torch.empty((4, 16), device="meta", dtype=torch.int32), None, a, 4),
        "strided": (torch.empty((16, 4), **META).t(), None, a, 4),
        "join of another size": (torch.empty((4, 16), **META), torch.empty((4, 32), **META), a, 4),
        "not on a CUDA device": (torch.empty((4, 16), **META), None, a, 4),
        "on the CPU": (torch.zeros((4, 16), dtype=torch.int64), None, a, 4),
        "alpha past p": (torch.empty((4, 16), **META), None, QM31(P, 0, 0, 0), 4),
    }
    for label, args in cases.items():
        with pytest.raises(ValueError):
            fri_fold_cuda.fold_layer(*args)
        assert fri_fold_cuda.LAUNCHES["fri_fold"] == 0, label


def test_merkle_wrapper_limits_raise():
    """Every limit of ops/merkle_cuda.py raises ValueError before any launch
    (meta tensors)."""
    big = merkle_cuda.MAX_NODES + 1
    cases = {
        "no node": (None, torch.empty((1, 0), **META), 0),
        f"{big} nodes": (None, torch.empty((1, big), **META), big),
        "a leaf without columns": (None, None, 8),
        "children of another count": (torch.empty((8, 8), **META), None, 8),
        "children of 16 words": (torch.empty((8, 16), **META), None, 8),
        "strided children": (torch.empty((8, 16), **META).t(), None, 8),
        "int32 children": (torch.empty((16, 8), device="meta", dtype=torch.int32), None, 8),
        "columns of another length": (None, torch.empty((3, 16), **META), 8),
        "columns strided along a row": (None, torch.empty((8, 3), **META).t(), 8),
        "not on a CUDA device": (None, torch.empty((3, 8), **META), 8),
        "on the CPU": (None, torch.zeros((3, 8), dtype=torch.int64), 8),
    }
    for label, args in cases.items():
        with pytest.raises(ValueError):
            merkle_cuda.level(*args)
        assert merkle_cuda.LAUNCHES["merkle_level"] == 0, label


def test_bounds():
    """A fold layer is bytes-bound, a Merkle level operations-bound; the
    counts follow the shapes (a join doubles the bytes read, a chunk of 8
    columns adds one permutation)."""
    assert fri_fold_cuda.bound_ms(22, True, False)[1] == "bytes"
    assert fri_fold_cuda.bound_ms(22, True, True)[1] == "bytes"
    one, both = fri_fold_cuda.layer_bytes(22, True, False), fri_fold_cuda.layer_bytes(22, True, True)
    assert both - one == 8 * (4 << 22) + 8 * (2 * (1 << 11) + 2 * (1 << 10))
    assert fri_fold_cuda.layer_ops(22, True, True) > 2 * fri_fold_cuda.layer_ops(22, True, False)
    assert merkle_cuda.permutations(12, False) == 3 and merkle_cuda.permutations(0, True) == 1
    assert merkle_cuda.permutations(48, True) == 8 and merkle_cuda.permutations(0, False) == 1
    assert merkle_cuda.bound_ms(12, False, 1 << 22)[1] == "operations"
