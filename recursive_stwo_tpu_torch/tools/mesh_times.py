"""Proofs/s of one batch split over ranks, and what each rank puts on the card.

chip_smoke.py phase 14 (d) times small_proof's clean B=1024 batch, split in
rank order, over 1, 2 and 4 gloo ranks sharing one card with these two
functions: time_shares inside every rank, summary in the parent.
"""

from __future__ import annotations

import statistics
import time


def time_shares(device, spec, batch, inputs, sizes, runs: int) -> dict:
    """Inside each rank: for every size N this rank takes part in (rank <
    N), the first N ranks each verify their share of the global numpy
    `batch` with verify_local (on a device-resident share, the collective
    verdict included) `runs` times after a warm call, each call started
    together (a barrier) and bounded by synchronize(), then once under a
    device-only torch.profiler trace.  Returns {N: {"walls": [s],
    "kernels": n, "copies_and_fills": n, "busy_ms": ms}}, the last three
    from that trace (this rank's own kernels)."""
    import torch
    import torch.distributed as dist

    from ..parallel import mesh as pmesh
    from .flavour_times import device_profile

    out = {}
    for size in sizes:
        group = dist.new_group(list(range(size)))
        if dist.get_rank() < size:
            mesh = pmesh.make_mesh(device, group)
            share = pmesh.shard_proof_arrays(batch, mesh)
            ok, all_ok = pmesh.verify_local(spec, share, inputs, mesh)
            if not all_ok or tuple(ok.shape) != (batch.commitments.shape[0],):
                raise RuntimeError(f"rank {mesh.rank}: the clean batch was rejected over {size} ranks")
            walls = []
            for _ in range(runs):
                dist.barrier(group)
                torch.cuda.synchronize()
                t = time.perf_counter()
                pmesh.verify_local(spec, share, inputs, mesh)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t)
            out[size] = dict(walls=walls, **device_profile(torch, lambda: pmesh.verify_local(spec, share, inputs, mesh)))
        dist.barrier()
    return out


def summary(timings: list, devices: list, batch: int) -> list:
    """One record per size from every rank's time_shares: proofs/s over the
    median of the slowest rank's walls; each rank's kernels and copies and
    fills; each card's kernel time (ms, summed over its ranks) and busy
    share."""
    rows = []
    for size in timings[0]:
        timed = [(str(devices[r]), t[size]) for r, t in enumerate(timings) if size in t]
        walls = [max(t["walls"][i] for _, t in timed) for i in range(len(timed[0][1]["walls"]))]
        med = statistics.median(walls)
        busy = {}
        for dev, t in timed:
            busy[dev] = busy.get(dev, 0.0) + t["busy_ms"]
        rows.append(dict(ranks=size, batch=batch, proofs_per_s=batch / med, wall_ms_median=med * 1e3,
                         wall_ms=[w * 1e3 for w in walls], kernels=[t["kernels"] for _, t in timed],
                         copies_and_fills=[t["copies_and_fills"] for _, t in timed], kernel_ms=busy,
                         busy_share={d: b / (med * 1e3) for d, b in busy.items()}))
    return rows
