"""Multi-device verification of the port (recursive_stwo_tpu_torch/parallel)
on gloo ranks on the CPU.

One module-scoped spawn of 8 ranks runs every case of tests/test_mesh.py on
small_proof at B=16; each case is asserted in its own test, and every named
check of every slot, gathered from every rank, is held to the JAX
package's host verify_batch on the same global numpy batch (tolerance 0,
keys in the same order).  The JAX mesh itself is not run: its sharded
compiles take minutes (tests/test_mesh.py is marked slow).  Then the dry
run at 8 and 16 ranks, and the launcher's refusals.  Each spawn has a
timeout of its own, so that a hung collective fails instead of holding the
suite.
"""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.multiprocessing import ProcessRaisedException

from recursive_stwo_tpu_torch.models import flagship
from recursive_stwo_tpu_torch.ops import launches
from recursive_stwo_tpu_torch.parallel import dryrun, launch
from recursive_stwo_tpu_torch.parallel import mesh as pmesh
from recursive_stwo_tpu_torch.verifier.verify import INPUTS_ONE

N_RANKS = 8
SPAWN_TIMEOUT = 300.0
# case -> (the mesh function, corruption, slot, batch): the cases of
# tests/test_mesh.py:44-138
CASES = {
    "sharded clean": ("verify_sharded", None, None, 16),
    "shard_map clean": ("verify_shard_map", None, None, 16),
    "sharded nonce 3": ("verify_sharded", "nonce", 3, 16),
    "sharded nonce 15": ("verify_sharded", "nonce", 15, 16),
    "shard_map nonce 9": ("verify_shard_map", "nonce", 9, 16),
    "padded clean": ("verify_sharded_padded", None, None, 11),
    "padded nonce 10": ("verify_sharded_padded", "nonce", 10, 11),
    "2-D clean": ("verify_shard_map_2d", None, None, 16),
    "2-D sample 12": ("verify_shard_map_2d", "sample", 12, 16),
}


def global_batch(case):
    """The case's global numpy batch of small_proof, corrupted as
    tests/test_mesh.py corrupts it (a nonce limb, or a sampled value)."""
    _, corruption, slot, batch = CASES[case]
    pa = flagship.tiled_batch(flagship.prepared_arrays("small_proof")[1], batch)
    if corruption == "nonce":
        pa.nonce_limbs[slot, 0] ^= 1
    elif corruption == "sample":
        pa.samples_flat[slot, 0, 0] ^= 1
    return pa


def run_cases(device):
    """Inside each rank: every case on a 1-D mesh of the world, or on a
    (2, world / 2) host x chip mesh, with the named checks gathered."""
    launches.reset()
    mesh = pmesh.make_mesh(device)
    mesh2 = pmesh.make_mesh_2d(device, (2, dist.get_world_size() // 2))
    spec = flagship.prepared_arrays("small_proof")[0]
    out = {}
    for case, (fn, *_) in CASES.items():
        res = getattr(pmesh, fn)(spec, global_batch(case), INPUTS_ONE, mesh2 if fn.endswith("_2d") else mesh,
                                 checks=True)
        *values, named = res
        out[case] = [v.numpy() if torch.is_tensor(v) else v for v in values] + [
            {k: v.numpy() for k, v in named.items()}]
    return {"cases": out, "launches": launches.counts()}


def reference(case) -> dict:
    """The JAX package's host verify_batch on the case's global batch.
    Imported here: the ranks import this module, and need no jax."""
    from recursive_stwo_tpu.verifier import verify as r_verify

    spec = flagship.prepared_arrays("small_proof")[0]
    return {k: np.asarray(v) for k, v in r_verify.verify_batch(spec, global_batch(case), r_verify.INPUTS_ONE).items()}


def held(ranks, case):
    """The case's result, after holding every rank's gathered checks to the
    reference slot by slot; the result's ok is the dict's."""
    want = reference(case)
    for r in ranks:
        *values, named = r["cases"][case]
        assert list(named) == list(want)
        for k in want:
            assert named[k].dtype == bool and np.array_equal(named[k], want[k]), (case, k)
        assert np.array_equal(values[0], named["ok"])
        assert all(np.array_equal(a, b) for a, b in zip(values, ranks[0]["cases"][case][:-1]))
    return ranks[0]["cases"][case][:-1]


@pytest.fixture(scope="module")
def ranks():
    return launch.spawn(run_cases, N_RANKS, "gloo", ("cpu",), timeout=SPAWN_TIMEOUT)


def test_verify_sharded_all_pass(ranks):
    ok, all_ok = held(ranks, "sharded clean")
    assert ok.shape == (16,) and ok.all() and all_ok


def test_verify_shard_map_all_pass(ranks):
    ok, all_ok = held(ranks, "shard_map clean")
    assert ok.shape == (16,) and ok.all() and all_ok


@pytest.mark.parametrize("bad_idx", [3, 15])
def test_fault_isolation_sharded(ranks, bad_idx):
    ok, all_ok = held(ranks, f"sharded nonce {bad_idx}")
    expect = np.ones(16, bool)
    expect[bad_idx] = False
    assert not all_ok and np.array_equal(ok, expect)


def test_fault_isolation_shard_map(ranks):
    ok, all_ok = held(ranks, "shard_map nonce 9")  # slot 9: rank 4 of 8, two proofs a rank
    assert not all_ok and not ok[9] and ok.sum() == 15


def test_uneven_batch_pads_to_mesh(ranks):
    ok, all_ok = held(ranks, "padded clean")
    assert ok.shape == (11,) and ok.all() and all_ok
    ok, all_ok = held(ranks, "padded nonce 10")
    assert ok.shape == (11,) and not all_ok and not ok[10] and ok[:10].all()


def test_two_level_host_chip_mesh(ranks):
    ok, per_host_bad, all_ok = held(ranks, "2-D clean")
    assert ok.all() and all_ok and per_host_bad.tolist() == [0, 0]
    ok, per_host_bad, all_ok = held(ranks, "2-D sample 12")  # slot 12: host 1 of (2, 4)
    assert not ok[12] and ok[np.arange(16) != 12].all()
    assert per_host_bad.tolist() == [0, 1] and not all_ok


def test_cpu_ranks_launch_no_kernel(ranks):
    assert all(v == 0 for r in ranks for v in r["launches"].values())


@pytest.mark.parametrize("n", [8, 16])
def test_dryrun_multichip(n):
    results = dryrun.dryrun_multichip(n, devices=("cpu",), timeout=SPAWN_TIMEOUT)
    assert len(results) == n
    verdicts = results[0]["verdicts"]
    expect = np.arange(n) != n // 2
    assert np.array_equal(verdicts["fault 1-D"], expect) and np.array_equal(verdicts["fault 2-D"], expect)
    assert verdicts["fault per-host"].tolist() == [0, 1]  # slot n // 2 lies on host (n // 2) // (n / 2)
    for case in ("small 1-D", "small 2-D", "deep 1-D", "deep 2-D", "padded", "sharded prep"):
        assert verdicts[case].all(), case
    assert [len(verdicts[c]) for c in ("small 1-D", "deep 1-D", "padded", "sharded prep")] == [2 * n, n, 2 * n + 1, 2 * n]
    # every hand-written kernel is counted, and CPU ranks launch none
    assert all(r["launches"] == dict.fromkeys(launches.KERNELS, 0) for r in results)


def never(device):
    raise AssertionError("no rank should start")


def test_nccl_refuses_ranks_sharing_a_device():
    with pytest.raises(ValueError, match="distinct CUDA device"):
        launch.spawn(never, 2, "nccl", ("cuda:0", "cuda:0"))
    with pytest.raises(ValueError, match="CUDA devices only"):
        launch.spawn(never, 1, "nccl", ("cpu",))


@pytest.mark.parametrize("fn", ["verify_sharded", "verify_shard_map"])
def test_uneven_batch_is_refused(fn):
    """B=16 over 3 ranks: refused before any collective (no process group
    is needed to see it)."""
    spec, pa1 = flagship.prepared_arrays("small_proof")
    mesh = pmesh.Mesh(rank=0, world=3, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        getattr(pmesh, fn)(spec, flagship.tiled_batch(pa1, 16), INPUTS_ONE, mesh)


def test_spawn_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        launch.spawn(never, 2, "gloo", ("cuda:0",))
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.dryrun_multichip(1, backend="nccl", devices=("cuda:0",))
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.dryrun_multichip(2)  # the card by default


def fail_on_rank_1(device):
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails")
    dist.barrier()  # rank 0 waits here for a rank that never comes


def test_failing_rank_fails_the_run():
    t = time.monotonic()
    with pytest.raises(ProcessRaisedException, match="rank 1 fails"):
        launch.spawn(fail_on_rank_1, 2, "gloo", ("cpu",), timeout=120.0)
    assert time.monotonic() - t < 60


def stuck(device):
    time.sleep(600)


def test_stuck_ranks_time_out():
    t = time.monotonic()
    with pytest.raises(TimeoutError):
        launch.spawn(stuck, 2, "gloo", ("cpu",), timeout=4.0)
    assert time.monotonic() - t < 30


def test_mesh_times_summary_reads_the_slowest_rank():
    """tools/mesh_times.summary: per run the slowest rank's wall, the median
    over runs, each rank's kernels and copies, and each card's kernel time
    summed over its ranks."""
    from recursive_stwo_tpu_torch.tools.mesh_times import summary

    def t(walls, kernels, copies, busy_ms):
        return dict(walls=walls, kernels=kernels, copies_and_fills=copies, busy_ms=busy_ms)

    timings = [
        {1: t([0.5, 0.3, 0.4], 27000, 40, 40.0), 2: t([0.2, 0.6, 0.2], 26000, 41, 30.0)},
        {2: t([0.3, 0.1, 0.1], 25000, 42, 20.0)},
    ]
    one, two = summary(timings, ["cuda:0", "cuda:1"], 1024)
    assert one["ranks"] == 1 and one["wall_ms_median"] == pytest.approx(400.0)
    assert one["proofs_per_s"] == pytest.approx(1024 / 0.4) and one["kernel_ms"] == {"cuda:0": 40.0}
    assert one["kernels"] == [27000] and one["copies_and_fills"] == [40]
    assert two["wall_ms"] == pytest.approx([300.0, 600.0, 200.0]) and two["wall_ms_median"] == pytest.approx(300.0)
    assert two["kernels"] == [26000, 25000] and two["copies_and_fills"] == [41, 42]
    assert two["kernel_ms"] == {"cuda:0": 30.0, "cuda:1": 20.0}
    assert two["busy_share"]["cuda:1"] == pytest.approx(20.0 / 300.0)
    shared = summary(timings, ["cuda:0", "cuda:0"], 1024)[1]
    assert shared["kernel_ms"] == {"cuda:0": 50.0}


def test_profiler_raw_events_are_readable():
    """tools/flavour_times.raw_events, which phase 14's busy share reads,
    on a CPU trace: names and durations of the ops that ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from recursive_stwo_tpu_torch.tools.flavour_times import raw_events

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4).add_(1)
    events = raw_events(torch, prof)
    assert any(d == DeviceType.CPU and n == "aten::add_" and ns >= 0 for d, n, ns in events)
