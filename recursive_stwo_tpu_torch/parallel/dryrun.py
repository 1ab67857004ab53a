"""The multi-device dry run: every sharded verification path over n ranks.

Twin of __graft_entry__.py::dryrun_multichip.

    dryrun_multichip(4)                                   # 4 gloo ranks share cuda:0
    dryrun_multichip(1, backend="nccl", devices=("cuda:0",))
    dryrun_multichip(8, devices=("cpu",))                 # 8 gloo ranks on the CPU

Each rank runs, and checks, every case of the JAX dry run (a failed check
raises in the rank and fails the call):
  - small_proof at 2n proofs, 1-D (verify_shard_map) and, for n >= 2, on a
    (2, n/2) host x chip mesh (verify_shard_map_2d);
  - the deep fixture recursive_proof_16_15 at n proofs, 1-D and 2-D;
  - 2n + 1 small proofs, padded to the next multiple of n;
  - fault localisation: one flipped sampled value at slot n // 2 of the
    deep batch is flagged at that slot only, and the 2-D per-host count
    puts it on host slot // (B / 2);
  - sharded host hint preparation: under SPMD each rank prepares its own
    two proofs with hints.prepare and verifies them where it stands
    (verify_local); the gathered verdict must be all true.
Returns, per rank, the verdicts of every case and the kernels' launches.
"""

from __future__ import annotations

import numpy as np
import torch.distributed as dist

from ..models import flagship
from ..ops import launches
from ..verifier import hints
from ..verifier.arrays import to_torch
from ..verifier.verify import INPUTS_ONE, INPUTS_RECURSIVE
from . import launch
from . import mesh as pmesh


def _require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"rank {dist.get_rank()}: {msg}")


def _all_true(ok, all_ok, size: int, what: str) -> None:
    _require(tuple(ok.shape) == (size,) and bool(ok.all()) and all_ok, f"{what} failed: {ok.tolist()}")


def _rank(device) -> dict:
    launches.reset()
    n = dist.get_world_size()
    mesh = pmesh.make_mesh(device)
    mesh2 = pmesh.make_mesh_2d(device, (2, n // 2)) if n >= 2 else None
    out = {}

    spec, pa_base = flagship.prepared_arrays("small_proof")
    pa = flagship.tiled_batch(pa_base, 2 * n)
    ok, all_ok = pmesh.verify_shard_map(spec, pa, INPUTS_ONE, mesh)
    _all_true(ok, all_ok, 2 * n, "small_proof 1-D")
    out["small 1-D"] = ok.numpy()
    if mesh2:
        ok, per_host, all_ok = pmesh.verify_shard_map_2d(spec, pa, INPUTS_ONE, mesh2)
        _all_true(ok, all_ok, 2 * n, "small_proof 2-D")
        _require(per_host.tolist() == [0, 0], f"small_proof 2-D per-host failures {per_host.tolist()}")
        out["small 2-D"] = ok.numpy()

    spec2, pa2 = flagship.prepared_arrays("recursive_proof_16_15")
    pa2 = flagship.tiled_batch(pa2, n)
    ok, all_ok = pmesh.verify_shard_map(spec2, pa2, INPUTS_RECURSIVE, mesh)
    _all_true(ok, all_ok, n, "deep fixture 1-D")
    out["deep 1-D"] = ok.numpy()
    if mesh2:
        ok, per_host, all_ok = pmesh.verify_shard_map_2d(spec2, pa2, INPUTS_RECURSIVE, mesh2)
        _all_true(ok, all_ok, n, "deep fixture 2-D")
        _require(per_host.tolist() == [0, 0], f"deep fixture 2-D per-host failures {per_host.tolist()}")
        out["deep 2-D"] = ok.numpy()

    ok, all_ok = pmesh.verify_sharded_padded(spec, flagship.tiled_batch(pa_base, 2 * n + 1), INPUTS_ONE, mesh)
    _all_true(ok, all_ok, 2 * n + 1, "padded uneven batch")
    out["padded"] = ok.numpy()

    bad_slot = n // 2
    pa_bad = pa2._replace(samples_flat=pa2.samples_flat.copy())
    pa_bad.samples_flat[bad_slot, 0, 0] ^= 1
    ok, all_ok = pmesh.verify_shard_map(spec2, pa_bad, INPUTS_RECURSIVE, mesh)
    expect = np.arange(n) != bad_slot
    _require(not all_ok and np.array_equal(ok.numpy(), expect),
             f"fault at slot {bad_slot} not localised: {ok.tolist()}")
    out["fault 1-D"] = ok.numpy()
    if mesh2:
        ok, per_host, all_ok = pmesh.verify_shard_map_2d(spec2, pa_bad, INPUTS_RECURSIVE, mesh2)
        host_of_bad = bad_slot // (n // 2)
        _require(not all_ok and np.array_equal(ok.numpy(), expect), f"2-D fault verdict {ok.tolist()}")
        _require(int(per_host.sum()) == 1 and int(per_host[host_of_bad]) == 1,
                 f"fault at slot {bad_slot} attributed to hosts {per_host.tolist()}, not host {host_of_bad}")
        out["fault 2-D"] = ok.numpy()
        out["fault per-host"] = per_host.numpy()

    proof, _ = flagship.load_fixture("small_proof")
    own = to_torch(hints.prepare(spec, [proof] * 2), mesh.device)
    ok, all_ok = pmesh.verify_local(spec, own, INPUTS_ONE, mesh)
    _all_true(ok, all_ok, 2 * n, "sharded host hint preparation")
    out["sharded prep"] = ok.numpy()
    return {"verdicts": out, "launches": launches.counts()}


def dryrun_multichip(n_devices: int, backend: str = "gloo", devices=("cuda:0",), timeout: float = 300.0) -> list:
    """Spawn n_devices ranks (launch.spawn) that each run the dry run, on
    the card unless `devices` says otherwise; raises if a rank fails a check
    or the ranks' verdicts differ.  Returns each rank's {"verdicts": case ->
    numpy array, "launches": kernel -> count}."""
    results = launch.spawn(_rank, n_devices, backend, devices, timeout=timeout)
    first = results[0]["verdicts"]
    for rank, r in enumerate(results):
        if list(r["verdicts"]) != list(first) or any(
            not np.array_equal(v, first[k]) for k, v in r["verdicts"].items()
        ):
            raise RuntimeError(f"rank {rank}'s verdicts differ from rank 0's")
    return results
