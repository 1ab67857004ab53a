"""Multi-device batched proof verification over torch.distributed ranks.

Twin of recursive_stwo_tpu/parallel/mesh.py.  The workload is data-parallel
over proofs: every proof's verification is independent, so the batch axis
is split over the ranks of a 1-D `proofs` mesh, each rank verifies its
contiguous rows with verify_batch on its own device, and collectives
combine the verdicts.  JAX has one controller over a device mesh; here
every function below is called inside each rank (parallel/launch.py starts
them), with the same global numpy batch on every rank, and returns the same
values on every rank:
  - `jax.lax.psum` of the failure count is `dist.all_reduce` (SUM);
  - an output sharded over `proofs` and read back is `dist.all_gather`;
  - `jax.distributed.initialize` is `init_process_group` (launch.spawn).

Every `verify_*` returns host values: `ok`, a (B,) bool CPU tensor, and
`all_ok`, a bool.  With `checks=True` it also returns every named check of
verify_batch gathered per slot, as a dict of (B,) bool CPU tensors with
verify_batch's keys in its order, `ok` last.  The verdicts travel as uint8
(NCCL gathers no bool); with gloo they are copied to the host for the
collective, while the verification itself stays on the rank's device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..verifier import verify as verify_mod
from ..verifier.arrays import ProofArrays, map_arrays, to_torch


class Mesh(NamedTuple):
    """The `proofs` axis of ranks: this rank's place on it, its size, the
    device this rank verifies on, and the axis' process group (None: the
    default one)."""

    rank: int
    world: int
    device: torch.device
    group: Optional[object] = None


class Mesh2D(NamedTuple):
    """A (hosts, chips) grid of ranks, host-major: rank = host * chips +
    chip.  groups are this rank's process groups along the (host, chip)
    axes: groups[1] holds this host's chips, groups[0] this chip index on
    every host.  The rows of a batch split over the ranks in rank order."""

    rank: int
    world: int
    device: torch.device
    groups: Tuple[object, object]


def make_mesh(device, group=None) -> Mesh:
    return Mesh(dist.get_rank(group), dist.get_world_size(group), torch.device(device), group)


def make_mesh_2d(device, shape=None) -> Mesh2D:
    """Hierarchical hosts x chips mesh over the default group.  The ranks
    are host-major, as the JAX package's reshape of the device list orders
    them; every rank creates every group of both axes, in the same order,
    as torch.distributed requires of new_group."""
    world = dist.get_world_size()
    shape = tuple(shape) if shape is not None else (2, world // 2)
    hosts, chips = shape
    if hosts * chips != world:
        raise ValueError(f"a {hosts} x {chips} mesh needs {hosts * chips} ranks, the group has {world}")
    rank = dist.get_rank()
    host, chip = divmod(rank, chips)
    per_host = [dist.new_group([h * chips + c for c in range(chips)]) for h in range(hosts)]
    per_chip = [dist.new_group([h * chips + c for h in range(hosts)]) for c in range(chips)]
    return Mesh2D(rank, world, torch.device(device), (per_chip[chip], per_host[host]))


def _rows(pa: ProofArrays, rank: int, world: int) -> ProofArrays:
    batch = pa.commitments.shape[0]
    if batch % world:
        raise ValueError(f"a batch of {batch} proofs does not split over {world} ranks "
                         "(verify_sharded_padded pads it)")
    n = batch // world
    return map_arrays(lambda x: x[rank * n:(rank + 1) * n], pa)


def shard_proof_arrays(pa: ProofArrays, mesh) -> ProofArrays:
    """This rank's contiguous rows of a global numpy batch, on its device."""
    return to_torch(_rows(pa, mesh.rank, mesh.world), mesh.device)


def _comm_device(device: torch.device, group) -> torch.device:
    return device if dist.get_backend(group) == "nccl" else torch.device("cpu")


def _local_checks(spec, pa_local, inputs, device, group):
    """(names, (n_checks, b) uint8 verdicts on the collective's device)."""
    checks = verify_mod.verify_batch(spec, pa_local, inputs)
    stacked = torch.stack(list(checks.values())).to(torch.uint8)
    return list(checks), stacked.to(_comm_device(device, group))


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """x of every rank of the group, concatenated in rank order on the last
    axis."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def _gathered(names, local, group) -> dict:
    rows = _all_gather(local, group).cpu().bool()
    return dict(zip(names, rows))


def _failures(local: torch.Tensor) -> torch.Tensor:
    return (local[-1] == 0).sum().to(torch.int64).reshape(1)


def _result(named: dict, all_ok: bool, checks: bool, *extra):
    out = (named["ok"],) + extra + (all_ok,)
    return out + (named,) if checks else out


def verify_sharded(spec, pa: ProofArrays, inputs, mesh: Mesh, checks: bool = False):
    """Batched verification over the mesh: (ok (B,), all_ok), the verdict
    gathered from every rank and its conjunction.  Raises unless the batch
    splits evenly over the ranks."""
    names, local = _local_checks(spec, shard_proof_arrays(pa, mesh), inputs, mesh.device, mesh.group)
    named = _gathered(names, local, mesh.group)
    return _result(named, bool(named["ok"].all()), checks)


def verify_sharded_padded(spec, pa: ProofArrays, inputs, mesh: Mesh, checks: bool = False):
    """verify_sharded for batch sizes that do not divide the mesh: the batch
    is padded by replicating row 0 (a structurally valid proof) up to the
    next multiple of the world; the verdicts are truncated back to the real
    prefix, and all_ok reads the prefix only, so the padding never counts."""
    batch = pa.commitments.shape[0]
    pad = (-batch) % mesh.world
    if pad:
        pa = map_arrays(lambda x: np.concatenate([x, np.repeat(x[:1], pad, axis=0)]), pa)
    *_, named = verify_sharded(spec, pa, inputs, mesh, checks=True)
    named = {k: v[:batch] for k, v in named.items()}
    return _result(named, bool(named["ok"].all()), checks)


def verify_local(spec, pa_local: ProofArrays, inputs, mesh: Mesh, checks: bool = False):
    """Each rank verifies its own batch (torch arrays on mesh.device, the
    same size on every rank), then the failure counts are summed with an
    all_reduce: (ok (world * b,), total failures == 0).  The local half of
    verify_shard_map; it also serves a batch that each rank prepared
    itself."""
    names, local = _local_checks(spec, pa_local, inputs, mesh.device, mesh.group)
    bad = _failures(local)
    dist.all_reduce(bad, op=dist.ReduceOp.SUM, group=mesh.group)
    return _result(_gathered(names, local, mesh.group), int(bad) == 0, checks)


def verify_shard_map(spec, pa: ProofArrays, inputs, mesh: Mesh, checks: bool = False):
    """verify_sharded with the verdict reduced as an explicit collective
    sum of the failure counts (the JAX package's shard_map + psum)."""
    return verify_local(spec, shard_proof_arrays(pa, mesh), inputs, mesh, checks)


def verify_shard_map_2d(spec, pa: ProofArrays, inputs, mesh: Mesh2D, checks: bool = False):
    """verify_shard_map over a (host, chip) mesh with a two-stage verdict
    reduction: the failures are summed over the host's chips first, then
    across hosts, so one count per host crosses between hosts.

    Returns (ok (B,), per_host_bad (n_hosts,), all_ok): per_host_bad[h] is
    host h's count after the first stage, gathered."""
    along_hosts, along_chips = mesh.groups
    names, local = _local_checks(spec, shard_proof_arrays(pa, mesh), inputs, mesh.device, None)
    bad = _failures(local)
    dist.all_reduce(bad, op=dist.ReduceOp.SUM, group=along_chips)
    per_host_bad = _all_gather(bad, along_hosts).cpu()
    total = bad.clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=along_hosts)
    return _result(_gathered(names, local, None), int(total) == 0, checks, per_host_bad)
