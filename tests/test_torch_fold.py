"""The port's fold phase against the JAX package's, at tolerance 0, and the
fold kernel's index tables against the quotients' sample batches.

For each verifier's fixture (small_proof, recursive_proof_16_15, np_small,
the level-14 and bitcoin artifacts, the last with its degree-0 last layer)
the port's `fold_phase` on the CPU (its plain version) and the JAX package's
`fold_phase` on numpy (xp=np) get the same batch and the same transcript:
the fri_last_layer check and every pair-walk job (each group's answers,
each inner layer's self values, the siblings and the queries) must agree
slot by slot, on a clean batch and on one with a sampled value and a
first-layer sibling corrupted in one slot.  The index table that
csrc/fold.cu reads columns and samples through must walk every group's
columns in `quotients_host.group_batches` order, naming each column's tree
block and sample as `spec.group_columns` and `spec.sample_offsets` do; the
block's per-proof table (each thread's entries) and a query's lane split of
each batch must cover every entry once, and its shared-memory layout fit a
block.  The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from recursive_stwo_tpu.verifier import points as r_points
from recursive_stwo_tpu.verifier import verify as r_verify
from recursive_stwo_tpu_torch.core import circle_host
from recursive_stwo_tpu_torch.models import flagship
from recursive_stwo_tpu_torch.ops import fold_cuda
from recursive_stwo_tpu_torch.tools import fold_cases
from recursive_stwo_tpu_torch.verifier import points as t_points
from recursive_stwo_tpu_torch.verifier import transcript_host
from recursive_stwo_tpu_torch.verifier import verify as t_verify
from recursive_stwo_tpu_torch.verifier.arrays import to_torch
from recursive_stwo_tpu_torch.verifier.quotients_host import group_batches
from recursive_stwo_tpu_torch.verifier.verify_sha256 import _map_tree

P = 2**31 - 1
BATCHES = {"small_proof": 3, "recursive_proof_16_15": 2, "np_small": 2, "level14": 2, "bitcoin": 2}
CORRUPT_SLOT = 1


def _batch(name: str, corrupt: bool) -> tuple:
    """(spec, numpy ProofArrays, numpy FSOutput) of a fixture at its batch
    size, the transcript replayed on the host after the corruption."""
    B = BATCHES[name]
    if name in ("level14", "bitcoin"):
        spec, pa1, fs1 = flagship.sha_prepared(name)
        transcript = lambda pa: _map_tree(lambda x: np.ascontiguousarray(np.broadcast_to(  # noqa: E731
            np.asarray(x), (B,) + np.asarray(x).shape[1:])), fs1)
    elif name == "np_small":
        spec, pa1 = flagship.prepared_arrays_np(name)
        transcript = lambda pa: transcript_host.run_transcript_np(spec, pa)  # noqa: E731
    else:
        spec, pa1 = flagship.prepared_arrays(name)
        transcript = lambda pa: transcript_host.run_transcript(spec, pa)  # noqa: E731
    pa = flagship.tiled_batch(pa1, B)
    if corrupt:
        pa.samples_flat[CORRUPT_SLOT, 0, 0] = (pa.samples_flat[CORRUPT_SLOT, 0, 0] + 1) % P
        sib = pa.first_layer_paths.sibling_columns[spec.max_first_layer_log]
        sib[CORRUPT_SLOT, 0, 0] = (sib[CORRUPT_SLOT, 0, 0] + 1) % P
    return spec, pa, transcript(pa)


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("corrupt", [False, True])
@pytest.mark.parametrize("name", fold_cases.FOLD_FIXTURES)
def test_plain_fold_phase_matches_reference(name, corrupt):
    spec, pa, fs = _batch(name, corrupt)
    ref_checks, ref_jobs = r_verify.fold_phase(spec, pa, fs, r_points.oods_point_from_t(fs.oods_t), np)

    fs_t = _map_tree(lambda x: torch.from_numpy(_np(x)), fs)
    checks, jobs = t_verify.fold_phase(spec, to_torch(pa, "cpu"), fs_t, t_points.oods_point_from_t(fs_t.oods_t))
    assert list(checks) == list(ref_checks) == ["fri_last_layer"]
    assert checks["fri_last_layer"].tolist() == np.asarray(ref_checks["fri_last_layer"]).tolist()
    assert len(jobs) == len(ref_jobs) == 1 + spec.n_inner_layers
    for job, ref in zip(jobs, ref_jobs):
        assert (job["kind"], job["depth"]) == (ref["kind"], ref["depth"])
        assert np.array_equal(job["queries"].numpy(), _np(ref["queries"])), job["kind"]
        for key in ("self_columns", "sibling_columns"):
            assert list(job[key]) == list(ref[key]), (job["kind"], key)
            for L in ref[key]:
                assert np.array_equal(job[key][L].numpy(), _np(ref[key][L])), (job["kind"], key, L)
    # the plain version's answers and self values are what the jobs carry
    answers, self_vals, last_ok = t_verify.fold_values_plain(
        spec, to_torch(pa, "cpu"), fs_t, t_points.oods_point_from_t(fs_t.oods_t))
    for g, L in enumerate(spec.all_log_sizes):
        assert np.array_equal(answers[g].numpy(), _np(ref_jobs[0]["self_columns"][L]))
    for i in range(spec.n_inner_layers):
        L = spec.max_first_layer_log - 1 - i
        assert np.array_equal(self_vals[i].numpy(), _np(ref_jobs[1 + i]["self_columns"][L]))
    want = [not (corrupt and b == CORRUPT_SLOT) for b in range(BATCHES[name])]
    assert last_ok.tolist() == want


def test_bitcoin_last_layer_is_degree_zero():
    spec, _, _ = _batch("bitcoin", False)
    assert spec.log_last_layer_degree_bound == 0
    assert flagship.prepared_arrays("recursive_proof_16_15")[0].log_last_layer_degree_bound == 8


@pytest.mark.parametrize("name", fold_cases.FOLD_FIXTURES)
def test_index_tables_walk_the_group_batches(name):
    spec = fold_cases.fold_case(name, 1, "cpu").spec
    t = fold_cuda.spec_tables(spec)
    k = 0
    for g, L in enumerate(spec.all_log_sizes):
        batches = group_batches(spec, g)
        assert t.group_batch[g + 1] - t.group_batch[g] == len(batches)
        for b, (key, cols) in enumerate(batches):
            first, n, cx, cy = t.batches[t.group_batch[g] + b]
            assert (first, n) == (k, len(cols))
            shift, tlog = key
            want = (1, 0) if shift == 0 else circle_host.point_at_index(
                (shift * circle_host.subgroup_gen_index(tlog)) % (1 << 31))
            assert (cx, cy) == tuple(want)
            for local, sample in cols:
                block, place, got_sample = t.columns[k]
                tree, col = spec.group_columns[g][local]
                assert t.blocks[block][:2] == (tree, L)
                # the column's place among its tree's columns of log size L
                same = [c for tr, c in spec.group_columns[g] if tr == tree]
                assert same[place] == col
                assert got_sample == sample
                assert spec.sample_offsets[tree][col] <= sample < spec.sample_offsets[tree][col] + \
                    len(spec.sample_shifts_per_column[tree][col])
                k += 1
    # an entry a sample: a column sampled at two points is read by two batches
    n_samples = sum(len(spec.sample_shifts_per_column[tree][col]) for cols in spec.group_columns for tree, col in cols)
    assert k == len(t.columns) == n_samples
    # every block is a tree's columns at one log size, as wide as the tree has them
    for tree, L, width in t.blocks:
        assert width == spec.n_columns_per_log_size[tree][L]


def test_cpu_fold_phase_takes_the_plain_version(monkeypatch):
    """On the CPU fold_phase never reaches the kernel's wrapper."""
    def refuse(*a, **k):
        raise AssertionError("the fold kernel's wrapper ran on a CPU batch")

    monkeypatch.setattr(fold_cuda, "fold", refuse)
    step, arrays = flagship.verifier_step("small_proof", 2, device="cpu")
    assert bool(step(arrays)["ok"].all())


def test_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper raises on a CPU tensor: the plain version is
    taken by the dispatch, never by the wrapper falling back."""
    case = fold_cases.fold_case("np_small", 1, "cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        fold_cases.fold_values(case)


def test_bound_counts_the_queries_point_additions():
    """The bound's data-dependent part: one addition a set bit of the
    masked query among bits 1..M-1, and one a set bit among 1..n_inner."""
    case = fold_cases.random_fold_case("small_proof", 2, 7, "cpu")
    spec, raw = case.spec, case.fs.raw_queries
    M, n_inner = spec.max_first_layer_log, spec.n_inner_layers
    want = 0
    for q in raw.flatten().tolist():
        q &= (1 << M) - 1
        want += sum((q >> k) & 1 for k in range(1, M)) + sum((q >> k) & 1 for k in range(1, n_inner + 1))
    assert fold_cuda.point_adds(spec, raw) == want
    ms, by = fold_cuda.fold_bound_ms(spec, raw)
    assert ms > 0 and by in ("bytes", "operations")


@pytest.mark.parametrize("name", fold_cases.FOLD_FIXTURES)
def test_block_tables_cover_every_entry_once(name):
    """A block's per-proof column table (each thread's entries, the device
    table's rows) and a query's lane split of each batch's columns cover
    every (column, sample) entry of spec_tables exactly once, each lane
    taking first + w, first + w + W, ... of each batch; the shared-memory
    layout's regions follow each other, QM31 ones 16-byte aligned, within
    an H100 block's shared memory."""
    case = fold_cases.fold_case(name, 1, "cpu")
    spec, n_queries = case.spec, case.fs.raw_queries.shape[1]
    t = fold_cuda.spec_tables(spec)
    entries = list(range(len(t.columns)))
    # csrc/fold.cu proof_coefficients: thread t computes the entries t, t + THREADS, ...
    threads = [range(th, len(entries), fold_cuda.THREADS) for th in range(fold_cuda.THREADS)]
    assert sorted(e for th in threads for e in th) == entries
    W = fold_cuda.lanes_per_query(n_queries)
    assert W * n_queries <= fold_cuda.THREADS and (W == 32 or 2 * W * n_queries > fold_cuda.THREADS)
    assert {16: 8, 8: 16}[n_queries] == W
    # csrc/fold.cu quotients: lane w sums the entries first + w, first + w + W, ... of each batch
    lanes = [[k for first, n, _, _ in t.batches for k in range(first + w, first + n, W)] for w in range(W)]
    assert sorted(e for lane in lanes for e in lane) == entries
    batch_of = fold_cuda.entry_batches(spec)
    for w, lane in enumerate(lanes):
        for e in lane:
            first = t.batches[batch_of[e]][0]
            assert (e - first) % W == w
    rows = fold_cuda._device_table(spec, "cpu").reshape(-1, 4).tolist()
    assert [tuple(r[:3]) for r in rows[:len(entries)]] == list(t.columns)
    assert [r[3] for r in rows[:len(entries)]] == list(batch_of)
    assert [tuple(r) for r in rows[len(entries):]] == list(t.batches)
    # the samples the entries name: each group's (tree, column, sample) once
    seen = {(g, t.columns[e][2]) for g in range(len(spec.all_log_sizes))
            for bt in range(t.group_batch[g], t.group_batch[g + 1])
            for e in range(t.batches[bt][0], t.batches[bt][0] + t.batches[bt][1])}
    assert len(seen) == len(entries)
    layout = fold_cuda.smem_layout(spec, n_queries)
    regions = dict(zip(fold_cuda.SMEM_REGIONS, zip(layout.offsets, layout.sizes)))
    spans = [(at, at + n) for name, (at, n) in regions.items() if name not in ("a", "b")]
    assert spans == sorted(spans) and all(end <= nxt for (_, end), (nxt, _) in zip(spans, spans[1:]))
    # A and B lie over the chunk's scratch and touch nothing step 1 does not write first
    lo, hi = regions[fold_cuda.SCRATCH[0]][0], regions["a"][0] + regions["a"][1] + regions["b"][1]
    assert regions["a"][0] == lo and regions["b"][0] == lo + regions["a"][1]
    assert all(at >= hi or at + n <= lo for name, (at, n) in regions.items()
               if name not in fold_cuda.SCRATCH + ("a", "b") and n)
    q_regions = fold_cuda.SMEM_REGIONS.index("inv")
    assert all(at % 4 == 0 for at in layout.offsets[:q_regions + 1] + (regions["a"][0], regions["b"][0]))
    assert layout.bytes == 4 * layout.offsets[-1] <= fold_cuda.SMEM_MAX
    assert layout.offsets[-1] == max(at + n for at, n in regions.values())
    assert fold_cuda.alpha_rows(spec) == max(sum(t.batches[bt][1] for bt in range(t.group_batch[g], t.group_batch[g + 1]))
                                             for g in range(len(spec.all_log_sizes)))
