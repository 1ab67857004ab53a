"""The SPMD launcher: `world` ranks on one host, one process and one device
each, joined in a torch.distributed process group.

The torch counterpart of building a mesh from `jax.devices()`.  JAX has one
controller over every device; here each rank is a process that runs
`fn(device, *args)` with the default process group initialised, and the
collectives of parallel/mesh.py join the ranks.

    results = spawn(fn, world, backend, devices, *args, timeout=300.0)

- `backend` is the caller's choice and nothing falls back from it: "nccl"
  needs a distinct CUDA device for every rank; "gloo" lets ranks share a
  device (every rank on "cuda:0", or on "cpu").  `devices` holds one device
  for every rank, or one device that every rank takes.  A CUDA device
  without a card raises (verifier/arrays.require_device).
- Rendezvous is a FileStore in a fresh temporary directory: no TCP port is
  chosen, so launchers running at once never collide.  The ranks share one
  host, so gloo and NCCL talk over the loopback interface unless
  GLOO_SOCKET_IFNAME / NCCL_SOCKET_IFNAME say otherwise.
- Each rank runs torch on one CPU thread, and the native host code on
  RSTPU_OMP_THREADS threads (utils/native.py: 1 unless set), so that many
  ranks on few CPUs do not thrash each other.
- The parent builds the CUDA kernels and the native library before it
  spawns, so that no rank runs a compiler.
- The ranks start with the `spawn` method.  A rank that raises fails the
  call with its traceback, after the other ranks are terminated; a run that
  outlasts `timeout` seconds (a hung collective) is killed and raises
  TimeoutError.  Each rank's result (picklable) comes back through a file
  in the temporary directory.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..verifier.arrays import require_device

BACKENDS = ("gloo", "nccl")


def rank_devices(world: int, backend: str, devices) -> list:
    """The device of each of `world` ranks, checked: raises for an unknown
    backend, a device list of another length than 1 or `world`, NCCL on
    anything but distinct CUDA devices, and a CUDA device without a card."""
    if world < 1:
        raise ValueError(f"world must be at least 1, got {world}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}, expected one of {BACKENDS}")
    devices = [torch.device(d) for d in devices]
    if len(devices) == 1:
        devices = devices * world
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks: give one, or one a rank")
    if backend == "nccl":
        if any(d.type != "cuda" for d in devices):
            raise ValueError(f"nccl runs on CUDA devices only, got {[str(d) for d in devices]}")
        if len({d.index or 0 for d in devices}) != world:
            raise ValueError(f"nccl needs a distinct CUDA device for every rank, got {[str(d) for d in devices]}; "
                             "ranks that share a device take gloo")
    devices = [require_device(d) for d in devices]
    if backend == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("this torch build has no NCCL")
    return devices


def _prebuild(devices) -> None:
    from ..utils import native

    native.available()
    if any(d.type == "cuda" for d in devices):
        from ..ops import build

        build.load()


def _rank_main(rank, fn, world, backend, devices, run_dir, timeout, args) -> None:
    torch.set_num_threads(1)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    store = dist.FileStore(os.path.join(run_dir, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    result = fn(device, *args)
    dist.barrier()
    dist.destroy_process_group()
    path = os.path.join(run_dir, f"rank{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".tmp", path)


def _kill(processes) -> None:
    for p in processes:
        if p.is_alive():
            p.kill()
    for p in processes:
        p.join()


def spawn(fn, world: int, backend: str, devices, *args, timeout: float = 300.0) -> list:
    """Run fn(device, *args) on `world` ranks (module docstring); returns
    the ranks' results in rank order."""
    devices = rank_devices(world, backend, devices)
    _prebuild(devices)
    with tempfile.TemporaryDirectory(prefix="rstpu_spawn_") as run_dir:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, backend, devices, run_dir, timeout, args),
            nprocs=world, join=False, start_method="spawn",
        )
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world} ranks ({backend}) did not finish in {timeout} s")
        finally:
            _kill(ctx.processes)
        results = []
        for rank in range(world):
            with open(os.path.join(run_dir, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
