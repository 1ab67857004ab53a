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
from recursive_stwo_tpu_torch.prover import flow as t_flow
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
    real = t_flow.quotients_stage

    def record(spec, blocks_by_log, samples_flat, oods, after_coeff):
        out = real(spec, blocks_by_log, samples_flat, oods, after_coeff)
        seen["args"] = (spec, {L: [b.clone() for b in bs] for L, bs in blocks_by_log.items()}, samples_flat, oods,
                        after_coeff)
        seen["out"] = out
        return out

    t_flow.quotients_stage = record
    try:
        if flavour == "np":
            from test_torch_chain import T_NP_CONFIG

            t_prove_np.prove_np(_np_trace(), T_NP_CONFIG, device="cpu")
        else:
            t_prove(flagship.demo_trace(), flagship.DEMO_CONFIG, device="cpu")
    finally:
        t_flow.quotients_stage = real
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


# ---- the FFT kernel's pass plan and index mapping, modelled in numpy ----------
# (csrc/circle_fft.cu: fft_pass_kernel's rounds, radix groups, cluster ranks,
# shared-memory words and twiddle slots; fft_tile_twiddle_kernel's table)

# a block's tile shrunk to 2**3-2**5 words, so that small transforms take
# clusters of up to 16 blocks and two passes
SMALL = fft_cuda.Limits(block_min=3, block_max=5, cluster_pref=3, cluster_max=4, split=6, min_run=1)


def _phys(e):
    """The shared-memory word of tile element e (a pad word after each 32)."""
    return e + ((e >> 5) << 2)


def _butterflies(v, w, Q, inverse):
    n = 1 << Q
    for i in range(Q):
        lay = i if inverse else Q - 1 - i
        half = 1 << lay
        for j in range(n):
            if j & half:
                continue
            t = w[n - (n >> lay) + (j >> (lay + 1))]
            if inverse:
                a, b = v[j], v[j + half]
                v[j], v[j + half] = (a + b) % P, (a - b) % P * t % P
            else:
                tb = v[j + half] * t % P
                v[j], v[j + half] = (v[j] + tb) % P, (v[j] - tb) % P


def _model_pass(ps, b, n_total, tw, inp, mask, out, inverse, scale):
    """One launch of fft_pass_kernel, every tile at once: `inp` (cols, ...)
    read at position & mask, `out` (cols, n_total) written."""
    k0, S, c, U, R, Bt = ps
    nth, per = fft_cuda.threads(ps), fft_cuda.WORDS_PER_THREAD
    words = fft_cuda.smem_bytes(ps) // 4
    tiles = n_total >> (U + S + c)
    tile = np.arange(tiles)[:, None, None]
    rank = np.arange(1 << R)[None, :, None]
    pbase = ((tile >> (k0 - c)) << (k0 + S + U)) + ((tile & ((1 << (k0 - c)) - 1)) << c)

    def position(E):
        return pbase + ((E >> c) << k0) + (E & ((1 << c) - 1))

    smem = np.zeros((inp.shape[0], tiles, 1 << R, words), np.int64)
    if S == 0:
        p = position(np.arange(1 << Bt))
        out[:, p] = inp[:, p & mask]
        return
    local, rounds = S - R, (S - R + 2) // 3
    seq = [("local", r) for r in (range(rounds) if inverse else reversed(range(rounds)))]
    if R:
        seq = seq + [("cluster", None)] if inverse else [("cluster", None)] + seq
    for at, (kind, r) in enumerate(seq):
        first, last = at == 0, at == len(seq) - 1
        if kind == "cluster":
            Q, k = R, Bt
            o = [(rh << (Bt - R)) + t + i * nth for rh in range(1 << R) for i in range(per >> R) for t in range(nth)
                 if t + i * nth < 1 << (Bt - R)]
            assert sorted(o) == list(range(1 << Bt))  # every offset once, each rank its share
            o = np.array(o).reshape(1 << R, -1)[None]
            p0, s0 = pbase + o, _phys(o)
            if inverse:
                v = [smem[:, tile, j, s0] for j in range(1 << Q)]
            else:
                v = [inp[:, (p0 & mask) + (j << k)] for j in range(1 << Q)]
        else:
            q0 = 3 * r
            Q = min(3, local - q0)
            s, k, groups = q0 + c, k0 + q0, 1 << (Bt - Q)
            g = [t + i * nth for i in range(per >> Q) for t in range(nth) if t + i * nth < groups]
            assert sorted(g) == list(range(groups))
            g = np.array(g)
            low = (1 << s) - 1
            e0 = (g & low) | ((g & ~low) << Q)
            p0 = position((rank << Bt) | e0)
            s0 = _phys(e0)
            d = [_phys(j << s) for j in range(1 << Q)]
            for j in range(1 << Q):  # the pad map is additive over the group's bits, and stays in the buffer
                assert np.array_equal(_phys(e0 | (j << s)), s0 + d[j]) and (s0 + d[j]).max() < words
            if Q == 3 and s == 0:  # 16-byte accesses: eight neighbours on 16 bytes of shared and device memory
                assert (s0 % 4 == 0).all() and (p0 % 8 == 0).all()
            v = ([inp[:, (p0 & mask) + (j << k)] for j in range(1 << Q)] if first
                 else [smem[:, tile, rank, s0 + d[j]] for j in range(1 << Q)])
        w = []
        for lay in range(Q):
            idx = n_total - (n_total >> (k + lay)) + (p0 >> (k + lay + 1))
            count = 1 << (Q - 1 - lay)
            assert (idx % count == 0).all()  # a vector load of `count` words
            w += [tw[idx + x] for x in range(count)]
        _butterflies(v, w, Q, inverse)
        if last:
            for j in range(1 << Q):
                out[:, p0 + (j << k)] = v[j] * scale % P if scale else v[j]
        elif kind == "cluster":
            for j in range(1 << Q):
                smem[:, tile, j, s0] = v[j]
        else:
            for j in range(1 << Q):
                smem[:, tile, rank, s0 + d[j]] = v[j]


def _model_transform(mode, src, b, G, tw, lim, scale=0):
    """The kernel's launches of a transform on the CPU: the passes of
    fft_cuda.plan(lim), the first from the sources (position mod 2**b)."""
    n_total = G << b
    out = np.zeros((src.shape[0], n_total), np.int64)
    steps = fft_cuda.plan(b, G, mode == fft_cuda.INTERPOLATE, lim)
    for i, ps in enumerate(steps):
        inp, mask = (src, (1 << b) - 1) if i == 0 else (out.copy(), -1)
        _model_pass(ps, b, n_total, tw, inp, mask, out, mode == fft_cuda.INTERPOLATE,
                    scale if i == len(steps) - 1 else 0)
    return out


def _model_tile_twiddles(bx, by, tx, ty, b):
    """fft_tile_twiddle_kernel: thread (g, j) on the even point 2j of tile
    g; layer k's twiddle of tile g's group i at N - (N >> k) + g 2**(b-k-1) + i."""
    G = bx.shape[0]
    n = G << b
    tw = np.zeros(max(n - G, 1), np.int64)
    ids = np.arange(G << (b - 1))
    g, j = ids >> (b - 1), ids & ((1 << (b - 1)) - 1)
    tw[(g << (b - 1)) + j] = (bx[g] * ty[2 * j] + by[g] * tx[2 * j]) % P
    act = (j & 1) == 0
    x, i = (bx[g] * tx[2 * j] - by[g] * ty[2 * j]) % P, j >> 1
    k = 1
    while b >= 2 and act.any():
        tw[(n - (n >> k) + (g << (b - 1 - k)) + i)[act]] = x[act]
        act &= (k + 1 < b) & ((i & 1) == 0)
        i, x, k = i >> 1, (2 * x * x - 1) % P, k + 1
    return tw


@pytest.mark.parametrize("b", range(28))
def test_fft_plan_passes_and_kernel_limits(b):
    """fft_cuda.passes: one pass up to a cluster's reach (2**14 words a block,
    16 blocks: 18 layers), two above.  Every pass of every transform the
    wrappers can ask for (whole columns with G = 1, 2 and up to 2**27
    points; tiles with an odd G) stays within the kernel's limits: 2**15
    words and 512 threads a block, 227 KB of shared memory, clusters of at
    most 16 (8 up to 17 layers), a whole number of tiles a column, layers
    [0, b) once each in the direction of the transform."""
    assert fft_cuda.passes(b) == (1 if b <= 18 else 2)
    assert fft_cuda.kernels_per_call(b, tiles=True) == fft_cuda.passes(b) + (b > 0)
    for G in sorted({1, 2, 3, 1 << (27 - b)}):
        if G << b > 1 << 27:
            continue
        for inverse in (True, False):
            steps = fft_cuda.plan(b, G, inverse)
            assert len(steps) == fft_cuda.passes(b)
            covered = 0
            for ps in steps:
                k0, S, c, U, R, Bt = ps
                assert Bt <= 15 and R <= (3 if S <= 17 else 4) and R <= Bt
                assert fft_cuda.threads(ps) <= 512 and fft_cuda.smem_bytes(ps) <= 232448
                assert U + S + c == Bt + R and c <= k0 and (k0 == 0 or U == 0) and (R == 0 or (U, k0) == (0, 0))
                assert (G << b) % (1 << (U + S + c)) == 0
                assert k0 == (covered if inverse else b - covered - S)
                covered += S
            assert covered == b


def _small_src(rng, cols, b):
    return rng.integers(0, P, (cols, 1 << b)).astype(np.int64)


@pytest.mark.parametrize("b", range(11))
def test_fft_model_holds_the_whole_column_transforms(b):
    """The kernel's index mapping (numpy model, a block's tile shrunk to
    2**3-2**5 words so that b = 4-9 take clusters of 2-16 blocks and b = 10
    two passes) against interpolate_plain, evaluate_plain and the LDE to 2
    and 8 times the size, bit for bit."""
    x = _small_src(_rng(700 + b), 3, b)
    table = fft_cuda._table(b, True, CPU).numpy().astype(np.int64)
    got = _model_transform(fft_cuda.INTERPOLATE, x, b, 1, table, SMALL, pow(1 << b, P - 2, P))
    assert np.array_equal(got, t_fft.interpolate_plain(_t(x)).numpy())
    for blowup in (0, 1, 3):
        if b + blowup > 11:
            continue
        table = fft_cuda._table(b + blowup, False, CPU).numpy().astype(np.int64)
        got = _model_transform(fft_cuda.EVALUATE, x, b, 1 << blowup, table, SMALL)
        want = t_fft.evaluate_plain(t_fft.extend(_t(x), b + blowup)).numpy()
        assert np.array_equal(got, want), blowup


@pytest.mark.parametrize("T,b,t0,t1", [(6, 1, 0, 32), (9, 3, 5, 12), (9, 5, 2, 6), (10, 7, 1, 4), (12, 8, 3, 5),
                                       (12, 9, 0, 1), (8, 2, 0, 64), (4, 0, 0, 7)])
def test_fft_model_holds_the_tile_evaluation(T, b, t0, t1):
    """The tile kernel's table (fft_tile_twiddle_kernel, modelled) and the
    pass kernel's mapping over it, on tiles of several column blocks, against
    the plain `_eval_tiles` with `_tile_twiddles`; tiles of one point copy
    the coefficient."""
    rng = _rng(10 * T + b)
    blocks = [_small_src(rng, w, b) for w in (2, 1, 3)]
    if b == 0:
        got = _model_transform(fft_cuda.TILES, np.concatenate(blocks), 0, t1 - t0, np.zeros(1, np.int64), SMALL)
        assert np.array_equal(got, np.repeat(np.concatenate(blocks), t1 - t0, axis=1))
        return
    tiles = t_tiles.circle_tiles(T, b, t0, t1, CPU)
    bx, by, tx, ty = (a.numpy() for a in (tiles.bx, tiles.by, tiles.tx, tiles.ty))
    tw = _model_tile_twiddles(bx, by, tx, ty, b) if b else np.zeros(1, np.int64)
    got = _model_transform(fft_cuda.TILES, np.concatenate(blocks), b, t1 - t0, tw, SMALL)
    assert np.array_equal(got, t_stream.eval_tiles([_t(blk) for blk in blocks], tiles).numpy())


@pytest.mark.parametrize("b,G", [(14, 1), (16, 2), (17, 1), (18, 1), (19, 1)])
def test_fft_model_at_the_hopper_plan(b, G):
    """The same model on the card's plan (fft_cuda.HOPPER: blocks of 2**13-2**14
    words, 128-256 threads, clusters of 2-16, two passes from b = 19) for
    one column, against the plain versions."""
    x = _small_src(_rng(b), 1, b)
    if G == 1:
        table = fft_cuda._table(b, True, CPU).numpy().astype(np.int64)
        got = _model_transform(fft_cuda.INTERPOLATE, x, b, 1, table, fft_cuda.HOPPER, pow(1 << b, P - 2, P))
        assert np.array_equal(got, t_fft.interpolate_plain(_t(x)).numpy())
    log = b + G.bit_length() - 1
    table = fft_cuda._table(log, False, CPU).numpy().astype(np.int64)
    got = _model_transform(fft_cuda.EVALUATE, x, b, G, table, fft_cuda.HOPPER)
    assert np.array_equal(got, t_fft.evaluate_plain(t_fft.extend(_t(x), log)).numpy())
