"""The provers' circle FFT and first-layer quotients of the port
(recursive_stwo_tpu_torch/prover/circle_fft.py, prover/stream.py's tile
evaluation, prover/quotients.py) against the JAX package on the CPU, at
tolerance 0 (every value an M31 residue), and the host side of their CUDA
kernels' wrappers (ops/fft_cuda.py, ops/quotients_cuda.py).

Inputs are seeded numpy.  The plain interpolate / evaluate / lde are held to
the jitted `interpolate_traced` / `evaluate_traced` / `_lde_t`, the plain tile
evaluation to the jitted `stream._eval_tiles` with `_tile_twiddles` (b = 0 and
1 included), `quotients_stage` to `_stage_quotients_jit(spec)`'s group
evaluations on the demo circuit's trees and samples, and
`_streamed_group_evals` to `_quot_chunk_jit` chunk by chunk.  The kernels
themselves run only on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recursive_stwo_tpu.prover import circle_fft as r_fft
from recursive_stwo_tpu.prover import device_prove as r_dev
from recursive_stwo_tpu.prover import stream as r_stream
from recursive_stwo_tpu.verifier import quotients as r_quot
from recursive_stwo_tpu.verifier.spec import NoPoseidonVerifierSpec as RNpSpec
from recursive_stwo_tpu.verifier.spec import VerifierSpec as RSpec
from recursive_stwo_tpu_torch.models import flagship
from recursive_stwo_tpu_torch.ops import fft_cuda, quotients_cuda
from recursive_stwo_tpu_torch.prover import circle_fft as t_fft
from recursive_stwo_tpu_torch.prover import device_prove as t_dev
from recursive_stwo_tpu_torch.prover import prove_np as t_prove_np
from recursive_stwo_tpu_torch.prover import quotients as t_quot
from recursive_stwo_tpu_torch.prover import stream as t_stream
from recursive_stwo_tpu_torch.prover import tiles as t_tiles
from recursive_stwo_tpu_torch.prover.prove import prove as t_prove
from recursive_stwo_tpu_torch.verifier.spec import NoPoseidonVerifierSpec

P = 2**31 - 1
CPU = torch.device("cpu")


def _rng(seed):
    return np.random.default_rng(seed)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _r_spec(spec):
    """The JAX package's spec of the port's spec."""
    cls = RNpSpec if isinstance(spec, NoPoseidonVerifierSpec) else RSpec
    return cls(**{f: getattr(spec, f) for f in cls.__dataclass_fields__})


# ---- circle FFT ----------------------------------------------------------------


@pytest.mark.parametrize("log_size", [1, 2, 6, 11])
@pytest.mark.parametrize("cols", [1, 3, 8])
def test_fft_plain_matches_jax(log_size, cols):
    """interpolate / evaluate / lde on the CPU (the plain versions, through
    the dispatch) against the jitted interpolate_traced / evaluate_traced /
    _lde_t, bit for bit."""
    x = _rng(100 * log_size + cols).integers(0, P, (cols, 1 << log_size), dtype=np.uint32)
    coeffs = jax.jit(r_fft.interpolate_traced)(jnp.asarray(x))
    got = t_fft.interpolate(_t(x))
    assert np.array_equal(got.numpy(), np.asarray(coeffs).astype(np.int64))
    assert np.array_equal(t_fft.evaluate(got).numpy(), np.asarray(jax.jit(r_fft.evaluate_traced)(coeffs)).astype(np.int64))
    assert np.array_equal(t_fft.evaluate(got).numpy(), x.astype(np.int64))
    for blowup in (1, 3):
        want = jax.jit(r_dev._lde_t, static_argnums=1)(coeffs, log_size + blowup)
        assert np.array_equal(t_fft.lde(got, log_size + blowup).numpy(), np.asarray(want).astype(np.int64))


def test_fft_dispatch_takes_the_plain_versions_on_the_cpu(monkeypatch):
    """A CPU tensor goes to interpolate_plain / evaluate_plain, never to
    the kernel's wrapper; leading dimensions are kept."""
    x = _t(_rng(5).integers(0, P, (2, 3, 1 << 5)))
    seen = []
    for name in ("interpolate_plain", "evaluate_plain"):
        real = getattr(t_fft, name)
        monkeypatch.setattr(t_fft, name, lambda v, real=real, name=name: seen.append(name) or real(v))
    for name in ("interpolate", "evaluate"):
        monkeypatch.setattr(fft_cuda, name, lambda *a: pytest.fail("the kernel's wrapper ran on the CPU"))
    c = t_fft.interpolate(x)
    assert c.shape == x.shape and torch.equal(t_fft.evaluate(c), x)
    assert t_fft.lde(c, 7).shape == (2, 3, 1 << 7)
    assert seen == ["interpolate_plain", "evaluate_plain", "evaluate_plain"]
    with pytest.raises(ValueError):
        t_fft.lde(c, 4)


# (T, b, t0, t1): b = 0 and 1 (a tile of one point, a tile of one butterfly),
# the JAX streamed tests' cases, tiles from the middle of the domain
TILE_EVAL_CASES = [(4, 0, 0, 1), (5, 1, 0, 16), (8, 1, 7, 40), (10, 6, 0, 16), (12, 9, 2, 6), (9, 9, 0, 1)]


@pytest.mark.parametrize("T,b,t0,t1", TILE_EVAL_CASES)
def test_tile_eval_plain_matches_jax(T, b, t0, t1):
    """The plain tile evaluation against the jitted `stream._eval_tiles`
    with `_tile_twiddles` on the JAX package's tile points; and the dispatch
    (`stream.eval_tiles`) over several coefficient blocks against the same
    of their concatenation."""
    rng = _rng(10 * T + b)
    coeffs = rng.integers(0, P, (5, 1 << b), dtype=np.uint32)
    if b == 0:  # the JAX package's tiles of one point: G = 1, no twiddles
        want = np.asarray(jax.jit(lambda c: r_stream._eval_tiles(c, [], 0))(jnp.asarray(coeffs)))
        got = t_stream._eval_tiles(_t(coeffs), [], 0, 1)
        assert np.array_equal(got.numpy(), want.astype(np.int64))
        return
    bx, by = r_stream.circle_tile_bases(T, b)
    tx, ty = r_stream.circle_tile_table(T, b)
    cx, cy = r_stream._tile_points(bx[t0:t1], by[t0:t1], tx, ty, r_stream._odd_mask(b))

    def ref(c, x, y):
        return r_stream._eval_tiles(c, r_stream._tile_twiddles(x, y, b), b)

    want = np.asarray(jax.jit(ref)(jnp.asarray(coeffs), jnp.asarray(cx), jnp.asarray(cy)))
    tiles = t_tiles.circle_tiles(T, b, t0, t1, CPU)
    pcx, pcy = tiles.points()
    assert np.array_equal(pcx.numpy(), cx.astype(np.int64)) and np.array_equal(pcy.numpy(), cy.astype(np.int64))
    got = t_stream._eval_tiles(_t(coeffs), t_stream._tile_twiddles(pcx, pcy, b), b, t1 - t0)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    split = [_t(coeffs[:2]), _t(coeffs[2:3]), _t(coeffs[3:])]
    assert torch.equal(t_stream.eval_tiles(split, tiles), got.reshape(5, -1))
    src = t_stream.CoeffSource(_t(coeffs), T)
    assert torch.equal(src.values(t0, t1), got.reshape(5, -1))


# ---- first-layer quotients -------------------------------------------------------


def _np_trace():
    from test_torch_chain import _np_trace as trace

    return trace()


@lru_cache(maxsize=None)
def _stage_inputs(flavour: str):
    """What `quotients_stage` is handed while the port proves the demo
    circuit on the CPU (`prove`, or `prove_np` for the without-Poseidon
    flavour): (spec, blocks_by_log, samples_flat, oods, after_coeff) and the
    first-layer columns it returned."""
    seen = {}
    module = t_prove_np if flavour == "np" else t_dev
    real = module.quotients_stage

    def record(spec, blocks_by_log, samples_flat, oods, after_coeff):
        out = real(spec, blocks_by_log, samples_flat, oods, after_coeff)
        seen["args"] = (spec, {L: [b.clone() for b in bs] for L, bs in blocks_by_log.items()}, samples_flat, oods,
                        after_coeff)
        seen["out"] = out
        return out

    module.quotients_stage = record
    try:
        if flavour == "np":
            from test_torch_chain import T_NP_CONFIG

            t_prove_np.prove_np(_np_trace(), T_NP_CONFIG, device="cpu")
        else:
            t_prove(flagship.demo_trace(), flagship.DEMO_CONFIG, device="cpu")
    finally:
        module.quotients_stage = real
    return seen["args"], seen["out"]


def _limbs8(oods) -> np.ndarray:
    return np.array([int(v) for c in oods for v in c], np.uint32)


@pytest.mark.parametrize("flavour", ["poseidon", "np"])
def test_quotients_stage_matches_jax(flavour):
    """quotients_stage (the plain version on the CPU) on the demo circuit's
    LDE blocks and samples against the group evaluations of the JAX
    package's `_stage_quotients_jit(spec)`, every group, bit for bit."""
    (spec, blocks_by_log, samples_flat, oods, after), got = _stage_inputs(flavour)
    ldes = {L: jnp.asarray(np.concatenate([b.numpy() for b in bs]).astype(np.uint32)) for L, bs in blocks_by_log.items()}
    doms = {L: tuple(jnp.asarray(v) for v in r_fft.domain_points_bit_reversed(L)) for L in ldes}
    group_evals, _ = r_dev._stage_quotients_jit(_r_spec(spec))(
        ldes, jnp.asarray(samples_flat), jnp.asarray(_limbs8(oods)), jnp.asarray(np.asarray(after, np.uint32)), doms)
    assert sorted(got) == sorted(group_evals)
    for L, ev in group_evals.items():
        assert np.array_equal(got[L].numpy(), np.stack([np.asarray(c) for c in ev]).astype(np.int64)), L


def test_streamed_group_evals_match_jax_quot_chunk():
    """The streamed quotients (`_streamed_group_evals`: a tile evaluation
    of the group's coefficient blocks and a quotient call a chunk) against
    the JAX package's `_quot_chunk_jit` chunk by chunk, on the demo
    circuit's coefficients, samples and OODS point, at chunks of 2**6."""
    (spec, blocks_by_log, samples_flat, oods, after), _ = _stage_inputs("poseidon")
    blowup = spec.log_blowup_factor
    # the LDE blocks' coefficients: the low 2**(L - blowup) of each block's
    # interpolation (the rest are zero)
    coeffs = {L: [t_fft.interpolate(b)[:, : b.shape[1] >> blowup] for b in bs] for L, bs in blocks_by_log.items()}
    for L, bs in coeffs.items():
        for c, b in zip(bs, blocks_by_log[L]):
            assert torch.equal(t_fft.lde(c, L), b)  # the blocks are LDEs of these coefficients
    chunk_log = 6
    inputs = t_quot.answer_inputs(samples_flat, oods, after, CPU)
    got = t_stream._streamed_group_evals(spec, coeffs, inputs, chunk_log, lambda msg: None)
    r_spec = _r_spec(spec)
    for g, L in enumerate(spec.all_log_sizes):
        cat = np.concatenate([c.numpy() for c in coeffs[L]]).astype(np.uint32)
        b = cat.shape[1].bit_length() - 1
        Cq = min(L, max(b, chunk_log))
        run = r_stream._quot_chunk_jit(r_spec, g, L, b, cat.shape[0], Cq)
        bx, by = r_stream.circle_tile_bases(L, b)
        G = 1 << (Cq - b)
        chunks = [np.asarray(run(jnp.asarray(cat), jnp.asarray(bx[j * G:(j + 1) * G]), jnp.asarray(by[j * G:(j + 1) * G]),
                                 jnp.asarray(samples_flat), jnp.asarray(_limbs8(oods)),
                                 jnp.asarray(np.asarray(after, np.uint32))))
                  for j in range(1 << (L - Cq))]
        assert len(chunks) > 1
        assert np.array_equal(got[L].numpy(), np.concatenate(chunks, axis=1).astype(np.int64)), L


# ---- the wrappers' host side -------------------------------------------------


def _specs():
    (spec, *_), _ = _stage_inputs("poseidon")
    (np_spec, *_), _ = _stage_inputs("np")
    return [spec, np_spec, flagship.load_fixture("small_proof")[1], flagship.load_fixture("recursive_proof_16_15")[1]]


def test_group_tables_follow_group_batches():
    """quotients_cuda.group_tables, read as the kernel reads it: each
    entry's column (its tree block and row) is the group column the JAX
    package's `group_batches` names, its sample that column's sample, in the
    JAX walk order; each batch's first entry and length are its run; the
    blocks are the trees' column counts at the group's log size, in tree
    order; the k of rc^k restarts each group."""
    for spec in _specs():
        r_spec = _r_spec(spec)
        for g, L in enumerate(spec.all_log_sizes):
            t = quotients_cuda.check_group(spec, g)
            trees = [tr for tr in range(4) if spec.n_columns_per_log_size[tr].get(L, 0)]
            assert t.widths == tuple(spec.n_columns_per_log_size[tr][L] for tr in trees)
            starts = np.cumsum((0,) + t.widths)
            walk = [(local, sample) for _, cols in r_quot.group_batches(r_spec, g) for local, sample in cols]
            assert len(walk) == len(t.entries)
            for (blk, row, sample, bt), (local, want_sample) in zip(t.entries, walk):
                assert starts[blk] + row == local and sample == want_sample
            firsts = [first for first, _, _, _ in t.batches]
            assert firsts == [sum(len(c) for _, c in r_quot.group_batches(r_spec, g)[:i])
                              for i in range(len(t.batches))]
            for i, (first, n, _, _) in enumerate(t.batches):
                assert [bt for _, _, _, bt in t.entries[first:first + n]] == [i] * n


def test_block_runs_map_tree_blocks_to_given_tensors():
    """The pointer and row table of the quotient kernel: each tree block of
    the group is a run of rows of one given tensor, whether the resident
    trees' blocks (one tensor a tree) or a chunk's evaluated columns (one
    tensor); a tree block split over two tensors, a wrong column count and
    a wrong point count raise ValueError."""
    x = torch.zeros((7, 16), dtype=torch.int64)
    assert [(id(b), r) for b, r in quotients_cuda.block_runs((2, 3, 2), [x], 16)] == [(id(x), 0), (id(x), 2),
                                                                                       (id(x), 5)]
    a, b = x[:2], x[2:]
    assert [(id(t), r) for t, r in quotients_cuda.block_runs((2, 3, 2), [a, b], 16)] == [(id(a), 0), (id(b), 0),
                                                                                         (id(b), 3)]
    with pytest.raises(ValueError):
        quotients_cuda.block_runs((3, 4), [a, b], 16)
    with pytest.raises(ValueError):
        quotients_cuda.block_runs((2, 3), [x], 16)
    with pytest.raises(ValueError):
        quotients_cuda.block_runs((2, 3, 2), [x], 8)


def test_quotient_kernel_limits_raise(monkeypatch):
    """A group past the kernel's limits (sampled columns, batches, blocks)
    raises ValueError, as does a CPU tensor handed to the kernel's wrapper:
    nothing is truncated and nothing falls back."""
    spec = flagship.load_fixture("small_proof")[1]
    t = quotients_cuda.check_group(spec, 0)
    for name, n in (("MAX_ENTRIES", len(t.entries)), ("MAX_BATCHES", len(t.batches)), ("MAX_BLOCKS", len(t.widths))):
        monkeypatch.setattr(quotients_cuda, name, n - 1)
        with pytest.raises(ValueError):
            quotients_cuda.check_group(spec, 0)
        monkeypatch.setattr(quotients_cuda, name, n)
        quotients_cuda.check_group(spec, 0)
    x = torch.zeros((spec.total_samples, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        quotients_cuda.quotients(spec, 0, x, (0,) * 8, (0,) * 4, [], (torch.zeros(4, dtype=torch.int64),) * 2)


def test_fft_kernel_limits_raise():
    """Lengths that are not powers of two, domains past 2**27, more than
    eight tile sources and CPU tensors raise ValueError."""
    for n in (0, 3, 1 << 28):
        with pytest.raises(ValueError):
            fft_cuda._log(n, "x")
    assert fft_cuda._log(1 << 27, "x") == 27
    x = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="coefficient blocks"):
        fft_cuda.eval_tiles([x] * 9, *(torch.zeros(1, dtype=torch.int64),) * 4)
    for call in (lambda: fft_cuda.interpolate(x), lambda: fft_cuda.evaluate(x, 4),
                 lambda: fft_cuda.eval_tiles([x], *(torch.zeros(1, dtype=torch.int64),) * 4)):
        with pytest.raises(ValueError, match="CUDA"):
            call()


@pytest.mark.parametrize("log_size", [1, 5, 9])
def test_fft_table_is_the_host_twiddles_flattened(log_size):
    """The whole-column kernel's int32 table: layer k of circle_fft_host's
    twiddles (the JAX package's `_twiddles` / `_inv_twiddles`) at 2**T -
    2**(T - k), as the kernel indexes it."""
    for inverse, layers in ((False, r_fft._twiddles(log_size)), (True, r_fft._inv_twiddles(log_size))):
        table = fft_cuda._table(log_size, inverse, CPU).numpy()
        assert table.dtype == np.int32 and table.size == (1 << log_size) - 1
        for k, layer in enumerate(layers):
            at = (1 << log_size) - (1 << (log_size - k))
            assert np.array_equal(table[at:at + layer.size], layer.astype(np.int32)), (inverse, k)


def test_bounds_count_what_the_kernels_must_move_and_compute():
    """The bounds' byte counts: a (96, 2**20) block's LDE to 2**21 reads
    the coefficients and twiddles once and writes the evaluations once; a
    quotient point reads each distinct sampled column once and writes four
    limbs.  Operation counts grow with the layers and the sampled columns."""
    tw = 4 * sum((1 << 21) >> (k + 1) for k in range(20))
    assert fft_cuda.transform_bytes(96, 20, 2, 1 << 20) == 96 * 3 * (1 << 20) * 8 + tw
    assert fft_cuda.transform_ops(1, 10, 1) < fft_cuda.transform_ops(1, 11, 1) < fft_cuda.transform_ops(1, 11, 1, True)
    ms, by = fft_cuda.bound_ms(96, 20, 2, 1 << 20)
    assert ms > 0 and by in ("bytes", "operations")
    spec = flagship.load_fixture("small_proof")[1]
    t = quotients_cuda.group_tables(spec, 0)
    columns = len({(blk, row) for blk, row, _, _ in t.entries})
    assert quotients_cuda.quotient_bytes(spec, 0, 1 << 10) == (1 << 10) * 8 * (columns + 4) + 16 * (1 << 10)
    assert quotients_cuda.point_ops(spec, 0) > 36 * len(t.entries)
    assert quotients_cuda.bound_ms(spec, 0, 1 << 20)[0] > 0
