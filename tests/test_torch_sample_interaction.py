"""The provers' OODS sampling and interaction columns of the port
(recursive_stwo_tpu_torch/prover/sample.py, prover/interaction.py) against
the JAX package on the CPU, at tolerance 0 (every value an M31 residue),
and the host side of their CUDA kernels (ops/sample_cuda.py,
ops/interaction_cuda.py, csrc/sample.cu, csrc/interaction.cu).

Inputs are seeded numpy.  The plain `sample` and `sample_many` are held to
the JAX package's `_sample_jit` (its `sample_columns` for the constant
polynomial); a numpy model of the sampling kernel's arithmetic (its Lo / Hi /
Top split of the basis at every split, its lanes' lazy 64-bit sums with
every bound asserted, its block combine) to the plain version; the plain
interaction columns to `_interaction_traced` (plonk, poseidon) and to
`air.interaction_columns` (without-Poseidon); and a scalar model of the
interaction kernel's generation sink (batch fractions, inverses with inv(0)
= 0, running sums and S) to the plain batch rows.  The kernels themselves
run only on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import os
import re
import types
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recursive_stwo_tpu.prover import air as r_air
from recursive_stwo_tpu.prover import device as r_device
from recursive_stwo_tpu.prover import device_prove as r_dev
from recursive_stwo_tpu.prover import prove as r_prove
from recursive_stwo_tpu.recursion import composition as r_comp
from recursive_stwo_tpu.verifier import composition as r_vcomp
from recursive_stwo_tpu_torch.core.qm31 import QM31
from recursive_stwo_tpu_torch.cs import scalar
from recursive_stwo_tpu_torch.models import flagship
from recursive_stwo_tpu_torch.ops import composition_cuda, interaction_cuda, launches, sample_cuda
from recursive_stwo_tpu_torch.prover import interaction as t_int
from recursive_stwo_tpu_torch.prover import sample as t_sample
from recursive_stwo_tpu_torch.tools import prover_cases
from recursive_stwo_tpu_torch.verifier import composition as vcomp
from test_torch_verify import run_blocked

P = 2**31 - 1
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "recursive_stwo_tpu_torch", "csrc")


def _rand(seed, *shape):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.int64)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _point(seed):
    rng = np.random.default_rng(seed)
    return tuple(tuple(int(x) for x in rng.integers(0, P, 4)) for _ in range(2))


# a proof's sampled shapes at small log sizes (what prover_cases.sample_case reads of a spec)
SMALL_SPEC = types.SimpleNamespace(log_size_plonk=6, log_size_poseidon=5, composition_log_degree_bound=8)
# (columns, log size, points) of each block chain level 1's proofs sample
LEVEL1_SHAPES = [(10, 19, 1), (40, 18, 1), (12, 19, 1), (48, 18, 1), (8, 19, 2), (8, 18, 2), (8, 20, 1)]


def _jax_sample(coeffs: np.ndarray, factors) -> np.ndarray:
    """The JAX package's sampling on the CPU: `_sample_jit`, or
    `sample_columns` for the constant polynomial."""
    n = coeffs.shape[1].bit_length() - 1
    if n == 0:
        return r_device.sample_columns(coeffs.astype(np.uint32), factors)
    return np.asarray(r_device._sample_jit(n)(jnp.asarray(coeffs.astype(np.uint32)),
                                              jnp.asarray(np.asarray(factors, np.uint32))))


# ---- (a) the plain sampling against the JAX package -------------------------


@pytest.mark.parametrize("log_size", [0, 1, 5, 7, 12])
@pytest.mark.parametrize("points", [1, 2])
def test_sample_many_matches_sample_jit(log_size, points):
    """sample_many on two blocks of one log size (one at one point, one at
    `points`) and `sample` alone, against `_sample_jit` block by block."""
    blocks = [_rand(log_size * 10 + k, 3 + k, 1 << log_size) for k in range(2)]
    facs = [np.asarray(r_prove._factors_at_point(log_size, _point(log_size + k)), np.uint32) for k in range(points)]
    jobs = [(_t(blocks[0]), facs[:1]), (_t(blocks[1]), facs)]
    got = t_sample.sample_many(jobs)
    for (block, fs), samples in zip(((blocks[0], facs[:1]), (blocks[1], facs)), got):
        assert len(samples) == len(fs)
        for f, s in zip(fs, samples):
            want = _jax_sample(block, f)
            assert s.dtype == np.uint32 and np.array_equal(s, want)
            assert np.array_equal(t_sample.sample(_t(block), f), want)


def test_samples_at_matches_sample_jit_on_a_proof_layout():
    """samples_at on a proof's blocks (the OODS point for every block, the
    shifted point for the interaction blocks) against `_sample_jit`, keyed as
    the provers' `_assemble_samples` reads them."""
    case = prover_cases.sample_case(SMALL_SPEC, "cpu", seed=4)
    oods = _point(9)
    shifted = _point(10)
    keys = [(t, tag) for t in range(3) for tag in "pq"] + [(3, "c")]
    col = {key: c for key, (c, _) in zip(keys, case.jobs)}
    got = t_sample.samples_at(col, oods, {(2, "p"): shifted, (2, "q"): shifted})
    assert sorted(got) == sorted([(k, 0) for k in keys] + [((2, "p"), -1), ((2, "q"), -1)])
    for (key, which), s in got.items():
        n = col[key].shape[1].bit_length() - 1
        point = oods if which == 0 else shifted
        assert np.array_equal(s, _jax_sample(col[key].numpy(), r_prove._factors_at_point(n, point)))


def test_sample_many_refuses_blocks_on_two_devices():
    x = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="lie on"):
        t_sample.sample_many([(x, [np.zeros((2, 4))]), (x.to("meta"), [np.zeros((2, 4))])])


# ---- (b) a numpy model of the sampling kernel ---------------------------------


def _constant(name: str) -> int:
    with open(os.path.join(CSRC, "sample.cu")) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);", f.read()).group(1))


def _doubling(factors, count):
    """Table entries 0 .. 2**count - 1 of the basis of `factors` by doubling,
    in python ints (cs/scalar.py's QM31)."""
    tab = [scalar.QONE]
    for f in factors[:count]:
        tab += [scalar.q_mul(v, tuple(int(x) for x in f)) for v in tab]
    return tab


def _lane_sums(run, lo):
    """A warp's 32 lanes over one run of 2**L coefficients, as sample_block
    does them: lane l takes k = l + 32 u + 128 i, four products into each
    limb sum between folds; every sum asserted below 2**64 and every fold
    below 2**34.  Returns the lanes' reduced QM31 sums."""
    out = []
    for lane in range(32):
        s = [0, 0, 0, 0]
        for k0 in range(lane, len(run), 128):
            for u in range(4):
                k = k0 + 32 * u
                if k < len(run):
                    s = [x + int(run[k]) * w for x, w in zip(s, lo[k])]
                    assert max(s) < 2**64
            s = [(x & P) + (x >> 31) for x in s]
            assert max(s) < 2**34
        out.append(tuple(x % P for x in s))
    return out


def _kernel_model(coeffs: np.ndarray, factors, lo_log: int, hi_log: int) -> np.ndarray:
    """The sampling kernel's arithmetic for one job at one point with the
    split L = min(n, lo_log), H = min(n - L, hi_log): a block a (column,
    chunk), its warps' runs times their Hi entries summed, times Top, added
    into a 64-bit output, then mod p."""
    n = coeffs.shape[1].bit_length() - 1
    L = min(n, lo_log)
    H = min(n - L, hi_log)
    rest = n - L - H
    lo, hi = _doubling(factors, L), _doubling(factors[L:], H)
    out = np.zeros((coeffs.shape[0], 4), dtype=object)
    for col in range(coeffs.shape[0]):
        for chunk in range(1 << rest):
            total = (0, 0, 0, 0)
            for h in range(1 << H):
                start = ((chunk << H) + h) << L
                lanes = _lane_sums(coeffs[col, start:start + (1 << L)], lo)
                run = (0, 0, 0, 0)
                for v in lanes:
                    run = scalar.q_add(run, v)
                total = scalar.q_add(total, scalar.q_mul(run, hi[h]))
            for k in range(rest):
                if (chunk >> k) & 1:
                    total = scalar.q_mul(total, tuple(int(x) for x in factors[L + H + k]))
            out[col] += np.array(total, dtype=object)
            assert max(out[col]) < 2**64
    return (out % P).astype(np.uint32)


def test_kernel_model_uses_the_kernel_constants():
    assert (_constant("kLoLog"), _constant("kHiLog"), _constant("kMaxLog")) == (10, 6, sample_cuda.MAX_LOG)
    assert (_constant("kMaxJobs"), _constant("kMaxLadders"), _constant("kMaxPoints")) == (
        sample_cuda.MAX_JOBS, sample_cuda.MAX_LADDERS, sample_cuda.MAX_POINTS)


@pytest.mark.parametrize("log_size,lo_log,hi_log", [(0, 10, 6), (1, 10, 6), (4, 2, 1), (8, 3, 2), (9, 0, 0),
                                                    (9, 9, 0), (9, 4, 5), (9, 5, 3), (11, 10, 6), (12, 10, 6),
                                                    (13, 7, 2)])
def test_kernel_model_matches_plain_sample(log_size, lo_log, hi_log):
    """The model at the kernel's split (10, 6) and at other splits, on
    random coefficients and on every coefficient at p - 1."""
    f = r_prove._factors_at_point(log_size, _point(log_size))
    for coeffs in (_rand(log_size, 2, 1 << log_size), np.full((1, 1 << log_size), P - 1, np.int64)):
        want = t_sample.sample(_t(coeffs), f)
        assert np.array_equal(_kernel_model(coeffs, np.asarray(f).reshape(-1, 4), lo_log, hi_log), want)


def test_lane_sums_hold_at_the_largest_products():
    """A lane's sums with every coefficient and every Lo limb at p - 1 (the
    largest products, four between folds) stay below 2**64, and reduce to
    the exact residue."""
    run = np.full(1 << 10, P - 1, np.int64)
    lo = [(P - 1,) * 4] * (1 << 10)
    for lane, got in enumerate(_lane_sums(run, lo)):
        assert got == (((P - 1) * (P - 1) * 32) % P,) * 4


# ---- the sampling wrapper's host side ---------------------------------------------


def test_ladders_share_a_point_across_log_sizes():
    """A proof's seven blocks at three points (the OODS point, it shifted at
    each component's log size) are three ladders; each job names the
    ladder of its points; the constant polynomial names any."""
    case = prover_cases.sample_case(SMALL_SPEC, "cpu", seed=2)
    assert sample_cuda.job_shapes(case.jobs) == [(10, 6, 1), (40, 5, 1), (12, 6, 1), (48, 5, 1), (8, 6, 2),
                                                 (8, 5, 2), (8, 7, 1)]
    lads, idx = sample_cuda.ladders(case.jobs)
    assert len(lads) == 3 and [len(x) for x in lads] == [7, 6, 5]
    assert idx == [[0], [0], [0], [0], [0, 1], [0, 2], [0]]
    for (c, points), row in zip(case.jobs, idx):
        n = c.shape[1].bit_length() - 1
        for f, k in zip(points, row):
            assert np.array_equal(lads[k][:n], np.asarray(f).reshape(-1, 4))
    lads, idx = sample_cuda.ladders([(torch.empty((1, 1), device="meta"), [np.zeros(0)])] + case.jobs[:1])
    assert len(lads) == 1 and idx == [[0], [0]]


@pytest.mark.parametrize("bad,match", [
    ("13 jobs", "1 to 12 jobs"), ("2**28", "n <= 27"), ("not a power of two", "2\\*\\*n coefficients"),
    ("three points", "1 to 2 points"), ("strided row", "contiguous along a row"), ("no columns", "C >= 1"),
    ("on the CPU", "CUDA device"), ("int32", "CUDA device"), ("factors", "ladder factors")])
def test_sample_wrapper_refuses(bad, match):
    """Every limit of csrc/sample.cu raises ValueError in the wrapper, before
    any launch (meta tensors: no memory is touched)."""
    meta = dict(device="meta", dtype=torch.int64)
    f3 = [np.zeros((3, 4))]
    jobs = {
        "13 jobs": [(torch.empty((1, 8), **meta), f3)] * 13,
        "2**28": [(torch.empty((1, 1 << 28), **meta), [np.zeros((28, 4))])],
        "not a power of two": [(torch.empty((1, 12), **meta), f3)],
        "three points": [(torch.empty((1, 8), **meta), f3 * 3)],
        "strided row": [(torch.empty((16, 8), **meta).t(), f3)],
        "no columns": [(torch.empty((0, 8), **meta), f3)],
        "on the CPU": [(torch.zeros((1, 8), dtype=torch.int64), f3)],
        "int32": [(torch.empty((1, 8), device="meta", dtype=torch.int32), f3)],
        "factors": [(torch.empty((1, 8), **meta), [np.zeros((2, 4))])],
    }[bad]
    with pytest.raises(ValueError, match=match):
        if bad == "factors":
            sample_cuda.ladders(jobs)
        else:
            sample_cuda.check_jobs(jobs)


def test_sample_bound_counts_each_coefficient_once():
    """At level 1's shapes the bound is the coefficients' bytes (about 0.39
    GB) over the card's rate: bytes-bound."""
    shapes = LEVEL1_SHAPES
    coeff_bytes = sum(c * (1 << n) * 8 for c, n, _ in shapes)
    assert coeff_bytes == 8 * (22 * 2**19 + 88 * 2**18 + 8 * 2**19 + 8 * 2**18 + 8 * 2**20)
    assert sample_cuda.sample_bytes(shapes) == coeff_bytes + 8 * 4 * sum(c * p for c, _, p in shapes)
    ms, by = sample_cuda.bound_ms(shapes)
    assert by == "bytes" and 0.11 < ms < 0.13


# ---- (c) the plain interaction columns against the JAX package --------------------


@lru_cache(maxsize=None)
def _tables():
    trace = flagship.demo_trace()
    pre_p, tr_p = r_air.plonk_columns(trace)
    pre_q, tr_q, _ = r_air.poseidon_columns(trace)
    return {"plonk": (pre_p, tr_p), "poseidon": (pre_q, tr_q)}


def _lookup(seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, P, 4).astype(np.uint32) for _ in range(2))


@lru_cache(maxsize=None)
def _interaction_jit(table: str):
    """The JAX package's `_interaction_traced` of a table, jitted once."""
    r_fn = {"plonk": r_vcomp.evaluate_plonk, "poseidon": r_vcomp.evaluate_poseidon}[table]
    return jax.jit(lambda a, b, z, al: r_dev._interaction_traced(a, b, z, al, r_fn))


@pytest.mark.parametrize("table", ["plonk", "poseidon"])
@pytest.mark.parametrize("seed", [0, 1])
def test_interaction_columns_match_interaction_traced(table, seed):
    pre, tr = _tables()[table]
    z4, alpha4 = _lookup(seed)
    t_fn = {"plonk": vcomp.evaluate_plonk, "poseidon": vcomp.evaluate_poseidon}[table]
    want_cols, want_total = _interaction_jit(table)(jnp.asarray(pre), jnp.asarray(tr), jnp.asarray(z4),
                                                    jnp.asarray(alpha4))
    cols, total = t_int.interaction_columns(_t(pre), _t(tr), (QM31(*map(int, z4)), QM31(*map(int, alpha4))), t_fn)
    assert cols.shape == (8, pre.shape[1])
    assert np.array_equal(cols.numpy(), np.asarray(want_cols).astype(np.int64))
    assert total.dtype == np.uint32 and np.array_equal(total, np.asarray(want_total, np.uint32))


def test_without_poseidon_interaction_columns_match_host():
    from test_torch_chain import _np_trace

    pre, tr = r_air.np_columns(_np_trace())
    z4, alpha4 = _lookup(7)
    want_cols, want_total = r_air.interaction_columns(pre, tr, z4, alpha4, r_comp.evaluate_plonk_np)
    cols, total = t_int.interaction_columns(_t(pre), _t(tr), (QM31(*map(int, z4)), QM31(*map(int, alpha4))),
                                            vcomp.evaluate_plonk_np)
    assert np.array_equal(cols.numpy(), np.asarray(want_cols).astype(np.int64))
    assert np.array_equal(total, np.asarray(want_total, np.uint32))


# ---- (d) a scalar model of the generation sink -------------------------------------


def _sink_model(fracs, batch: int, row: int):
    """The interaction kernel's `Generate` sink at one row, in python ints:
    each batch's p / q folded as finalize_logup folds it, p q^-1 (inv(0) =
    0), the running sums; returns the (4 k,) batch rows."""
    def at(v):
        return tuple(int(limb[row]) if limb.dim() else int(limb) for limb in v)

    acc, out = (0, 0, 0, 0), []
    for k in range(0, len(fracs), batch):
        p, q = (at(v) for v in fracs[k])
        for mult, den in fracs[k + 1:k + batch]:
            p = scalar.q_add(scalar.q_mul(p, at(den)), scalar.q_mul(at(mult), q))
            q = scalar.q_mul(q, at(den))
        inv = (0, 0, 0, 0) if q == (0, 0, 0, 0) else scalar.q_inv(q)
        acc = scalar.q_add(acc, scalar.q_mul(p, inv))
        out += list(acc)
    return out


@pytest.mark.parametrize("air", [composition_cuda.PLONK, composition_cuda.POSEIDON, composition_cuda.PLONK_NP])
def test_generation_sink_model_matches_plain_rows(air):
    """Random rows (n = 64) of each AIR, z planted so that row 17's first
    relation has a zero denominator (plonk, without-Poseidon): the model's
    batch rows equal the plain batch rows at every row, and row 17's first
    batch is 0."""
    n_pre, n_tr, _, batch = composition_cuda.AIR_SHAPES[air]
    fn = {composition_cuda.PLONK: vcomp.evaluate_plonk, composition_cuda.POSEIDON: vcomp.evaluate_poseidon,
          composition_cuda.PLONK_NP: vcomp.evaluate_plonk_np}[air]
    pre, tr = _t(_rand(air, n_pre, 64)), _t(_rand(air + 10, n_tr, 64))
    z, alpha = (tuple(int(x) for x in _rand(air + 20 + k, 4)) for k in range(2))
    planted = air != composition_cuda.POSEIDON
    if planted:
        z = scalar.q_add(tuple(int(v) for v in tr[:4, 17]), scalar.q_mul_m31(alpha, int(pre[0, 17])))
    ev = t_int._InteractionEval(pre, tr)
    fn(ev, (QM31(*z), QM31(*alpha)))
    rows = t_int.interaction_rows_plain(pre, tr, (QM31(*z), QM31(*alpha)), fn)
    assert torch.equal(rows, ev.rows) and rows.shape == (8, 64)
    for row in range(64):
        assert [int(v) for v in rows[:, row]] == _sink_model(ev.fracs, batch, row)
    if planted:
        assert rows[:4, 17].tolist() == [0, 0, 0, 0] and rows[:4, 16].any()


def test_close_is_the_last_column_and_total():
    """_close on batch rows: the total is S summed mod p, the last column
    the prefix sum of S - total / N, row by row in python ints."""
    rows = _t(_rand(3, 8, 32))
    S = rows[-4:].clone()
    total = t_int._close(rows)
    want = [int(v) % P for v in S.sum(dim=1)]
    assert total.tolist() == want
    shift = scalar.q_mul_m31(tuple(want), scalar.m_inv(32))
    run = [0, 0, 0, 0]
    for j in range(32):
        run = [(r + int(S[k, j]) - shift[k]) % P for k, r in enumerate(run)]
        assert rows[4:, j].tolist() == run


# ---- the interaction wrapper's host side ------------------------------------------


@pytest.mark.parametrize("air", [composition_cuda.PLONK, composition_cuda.POSEIDON, composition_cuda.PLONK_NP])
def test_interaction_reads_are_the_rows_the_relations_read(air):
    """READS (the bound's bytes) names exactly the preprocessed and trace
    rows whose values change the plain batch rows."""
    n_pre, n_tr, _, _ = composition_cuda.AIR_SHAPES[air]
    fn = {composition_cuda.PLONK: vcomp.evaluate_plonk, composition_cuda.POSEIDON: vcomp.evaluate_poseidon,
          composition_cuda.PLONK_NP: vcomp.evaluate_plonk_np}[air]
    pre, tr = _t(_rand(air, n_pre, 8)), _t(_rand(air + 1, n_tr, 8))
    lookup = (QM31(*(int(x) for x in _rand(5, 4))), QM31(*(int(x) for x in _rand(6, 4))))
    base = t_int.interaction_rows_plain(pre, tr, lookup, fn)
    read = []
    for which, block in ((0, pre), (1, tr)):
        used = []
        for i in range(block.shape[0]):
            moved = block.clone()
            moved[i] = (moved[i] + 12345) % P
            args = (moved, tr) if which == 0 else (pre, moved)
            if not torch.equal(t_int.interaction_rows_plain(*args, lookup, fn), base):
                used.append(i)
        read.append(tuple(used))
    assert tuple(read) == interaction_cuda.READS[air]


@pytest.mark.parametrize("air", [composition_cuda.PLONK, composition_cuda.POSEIDON, composition_cuda.PLONK_NP])
def test_interaction_bound(air):
    """A row's bytes are its read rows and 8 written rows; its operations
    include two batch inverses (37 products each); the relations' work is
    far below the domain kernel's with its constraints."""
    pre, tr = interaction_cuda.READS[air]
    assert interaction_cuda.row_bytes(air) == 8 * (len(pre) + len(tr) + 8)
    assert 2 * 37 * 6 < interaction_cuda.row_ops(air) < composition_cuda.domain_ops(air, True)
    ms, by = interaction_cuda.bound_ms(air, 1 << 19)
    assert ms > 0 and by in ("bytes", "operations")


def test_interaction_wrapper_refuses():
    x = torch.zeros((10, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        interaction_cuda.interaction_rows(composition_cuda.PLONK, x, torch.zeros((12, 8), dtype=torch.int64),
                                          (QM31(0, 0, 0, 0),) * 2)
    meta = dict(device="meta", dtype=torch.int64)
    with pytest.raises(ValueError, match=r"\(12, 8\)"):
        interaction_cuda.interaction_rows(composition_cuda.PLONK, torch.empty((10, 8), **meta),
                                          torch.empty((11, 8), **meta), (QM31(0, 0, 0, 0),) * 2)
    with pytest.raises(ValueError, match="no interaction kernel"):
        interaction_cuda.interaction_rows(7, x, x, (QM31(0, 0, 0, 0),) * 2)


def test_launch_counts_name_both_kernels():
    assert {"sample", "interaction"} <= set(launches.counts())
    assert "sample" in launches.KERNELS and "interaction" in launches.KERNELS


def test_composition_air_generation_mode_leaves_the_other_sinks():
    """csrc/composition_air.cuh: the check and domain sinks declare
    kGenerate false, the emit and the batch end branch on it at compile time,
    and the poseidon rounds are skipped only in generation mode;
    interaction.cu's sink is the one generating sink."""
    with open(os.path.join(CSRC, "composition_air.cuh")) as f:
        header = f.read()
    with open(os.path.join(CSRC, "interaction.cu")) as f:
        kernel = f.read()
    assert header.count("static constexpr bool kGenerate = false;") == 2
    assert "if constexpr (!Sink::kGenerate) h.emit(src, v);" in header
    assert "if constexpr (Sink::kGenerate) {" in header
    assert "if constexpr (!Sink::kGenerate) poseidon_rounds(s, ev);" in header
    assert kernel.count("static constexpr bool kGenerate = true;") == 1


# ---- (e) the guards ------------------------------------------------------------


def test_sample_and_interaction_never_import_jax():
    """With jax and the JAX package refused: the wrappers import, and the
    demo circuit's OODS samples and interaction columns run on the CPU."""
    run_blocked(
        "import numpy as np, torch\n"
        "from recursive_stwo_tpu_torch.ops import sample_cuda, interaction_cuda\n"
        "from recursive_stwo_tpu_torch.models import flagship\n"
        "from recursive_stwo_tpu_torch.core.qm31 import QM31\n"
        "from recursive_stwo_tpu_torch.prover import interaction, sample\n"
        "from recursive_stwo_tpu_torch.prover.arrays import trace_to_torch\n"
        "from recursive_stwo_tpu_torch.verifier import composition as vcomp\n"
        "ta = trace_to_torch(flagship.demo_trace(), 'cpu')\n"
        "cols, total = interaction.interaction_columns(ta.plonk_pre, ta.plonk_tr, (QM31(1, 2, 3, 4), QM31(5, 6, 7, 8)),\n"
        "                                              vcomp.evaluate_plonk)\n"
        "assert cols.shape[0] == 8 and total.shape == (4,)\n"
        "got = sample.samples_at({0: cols}, ((1, 2, 3, 4), (5, 6, 7, 8)), {0: ((9, 1, 2, 3), (4, 5, 6, 7))})\n"
        "assert sorted(got) == [(0, -1), (0, 0)] and got[(0, 0)].shape == (8, 4)\n"
    )


# ---- eager and hand-written kernels by prover stage ---------------------------------


def test_kernels_by_stage_split_eager_from_hand_written():
    """tools/prover_memory.by_stage on a trace's raw events: each CUDA
    kernel goes to the stage range its start falls in, hand-written
    (csrc/'s __global__ names) apart from eager; copies, fills and the
    ranges' own device rows are not kernels; a kernel outside every range
    is counted apart."""
    from torch.autograd import DeviceType

    from recursive_stwo_tpu_torch.tools import prover_memory as pm

    def event(name, device, start, end):
        return types.SimpleNamespace(name=lambda: name, device_type=lambda: device, start_ns=lambda: start,
                                     end_ns=lambda: end, duration_ns=lambda: end - start)

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [event(f"{pm.STAGE}0", cpu, 0, 100), event(f"{pm.STAGE}1", cpu, 100, 200),
              event("void at::native::vectorized_elementwise_kernel", cuda, 10, 2_000_010),
              event("(anonymous namespace)::interaction_kernel<1>(long const*)", cuda, 40, 50),
              event("(anonymous namespace)::sample_kernel(Args, unsigned long long*)", cuda, 150, 160),
              event("Memcpy HtoD (Pageable -> Device)", cuda, 150, 160), event(f"{pm.STAGE}1", cuda, 100, 200),
              event("void at::native::reduce_kernel", cuda, 250, 260)]
    got = pm.by_stage(events, ["interaction columns generated", "OODS samples computed"])
    assert got == [
        dict(stage="interaction columns generated", kernels=2, hand_written=1, eager=1, busy_ms=2.0),
        dict(stage="OODS samples computed", kernels=1, hand_written=1, eager=0, busy_ms=0.0),
        dict(stage="outside every stage", kernels=1),
    ]
