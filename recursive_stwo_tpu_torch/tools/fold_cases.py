"""Inputs of the fold kernel at the port's shapes, for the tests,
chip_smoke.py and tools/kernel_times.py.

  fold_case(name, batch, device, corrupt=False) -> FoldCase
      the fold phase's inputs of one of FOLD_FIXTURES (each verifier's
      fixture or artifact), from its own transcript run once on the CPU at
      batch 1, tiled to `batch` proofs on `device`; `corrupt` changes four
      slots (CORRUPTIONS: a sampled value, a first-layer sibling, an
      inner-layer sibling, and an OODS point in the base field, whose
      quotient denominators are all zero)
  random_fold_case(name, batch, seed, device) -> FoldCase
      the fixture's shapes with random canonical samples, tree columns,
      siblings, last-layer polynomials, queries, OODS point, random
      coefficient and FRI alphas; slot 0's OODS point in the base field
  fold_values(case, plain=False) -> (answers, self_vals, (B,) bool)
      the fold kernel on a CUDA case, or with `plain` the plain version
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.qm31 import QM31
from ..models import flagship
from ..verifier import points, transcript
from ..verifier import verify as verify_mod
from ..verifier.arrays import map_arrays, to_torch
from ..verifier.verify_sha256 import _map_tree, tile_fs

P = 2**31 - 1
# the fixtures of verify_batch, verify_batch_np and the SHA-256 flavours
FOLD_FIXTURES = ("small_proof", "recursive_proof_16_15", "np_small", "level14", "bitcoin")
# what `corrupt` changes, one slot each (taken modulo the batch)
CORRUPTIONS = ("sampled value", "first-layer sibling", "inner-layer sibling", "zero quotient denominator")
CORRUPT_SLOTS = (1, 2, 3, 4)


class FoldCase(NamedTuple):
    spec: object
    pa: object  # ProofArrays of int64 tensors
    fs: object  # FSOutput of int64 tensors
    oods: tuple  # (x, y), QM31 of (B,) limbs


def _batch1(name: str) -> tuple:
    """(spec, pa, fs) of a fixture at batch 1 on the CPU."""
    if name in ("level14", "bitcoin"):
        spec, pa, fs = flagship.sha_prepared(name)
        return spec, to_torch(pa, "cpu"), tile_fs(fs, 1, "cpu")
    if name == "np_small":
        spec, pa = flagship.prepared_arrays_np(name)
        pa = to_torch(pa, "cpu")
        return spec, pa, transcript.run_transcript_np(spec, pa)
    if name not in FOLD_FIXTURES:
        raise ValueError(f"unknown fixture {name!r}, expected one of {FOLD_FIXTURES}")
    spec, pa = flagship.prepared_arrays(name)
    pa = to_torch(pa, "cpu")
    return spec, pa, transcript.run_transcript(spec, pa)


def _tiled(name: str, batch: int, device) -> tuple:
    spec, pa, fs = _batch1(name)

    def tile(x):
        return x.expand((batch,) + tuple(x.shape[1:])).contiguous().to(device)

    return spec, map_arrays(tile, pa), _map_tree(tile, fs)


def _with_oods(spec, pa, fs) -> FoldCase:
    return FoldCase(spec, pa, fs, points.oods_point_from_t(fs.oods_t))


def _base_field(oods: tuple, slot: int) -> tuple:
    """The OODS point with slot's imaginary limbs (c, d) zeroed."""
    out = []
    for p in oods:
        c, d = p.c.clone(), p.d.clone()
        c[slot] = d[slot] = 0
        out.append(QM31(p.a, p.b, c, d))
    return tuple(out)


def fold_case(name: str, batch: int, device, corrupt: bool = False) -> FoldCase:
    spec, pa, fs = _tiled(name, batch, device)
    case = _with_oods(spec, pa, fs)
    if not corrupt:
        return case
    M = spec.max_first_layer_log
    s_sample, s_first, s_inner, s_zero = (s % batch for s in CORRUPT_SLOTS)
    pa.samples_flat[s_sample, 0, 0] = (pa.samples_flat[s_sample, 0, 0] + 1) % P
    first = pa.first_layer_paths.sibling_columns[M]
    first[s_first, 0, 0] = (first[s_first, 0, 0] + 1) % P
    if spec.n_inner_layers:
        inner = pa.inner_layer_paths[0].sibling_columns[M - 1]
        inner[s_inner, 0, 1] = (inner[s_inner, 0, 1] + 1) % P
    return case._replace(oods=_base_field(case.oods, s_zero))


def random_fold_case(name: str, batch: int, seed: int, device) -> FoldCase:
    spec, pa, fs = _tiled(name, batch, device)
    rng = np.random.default_rng(seed)

    def rand(x):
        return torch.from_numpy(rng.integers(0, P, tuple(x.shape))).to(device)

    pa = map_arrays(rand, pa)
    fs = _map_tree(rand, fs)._replace(
        raw_queries=torch.from_numpy(rng.integers(0, 1 << 32, tuple(fs.raw_queries.shape))).to(device))
    case = _with_oods(spec, pa, fs)
    return case._replace(oods=_base_field(case.oods, 0))


def fold_values(case: FoldCase, plain: bool = False) -> tuple:
    """(answers (G, B, Q, 4), self values (n_inner, B, Q, 4), (B,) bool)."""
    if plain:
        return verify_mod.fold_values_plain(case.spec, case.pa, case.fs, case.oods)
    from ..ops import fold_cuda

    return fold_cuda.fold(case.spec, case.pa, case.fs.raw_queries, case.oods,
                          case.fs.after_sampled_values_random_coeff, case.fs.fri_alphas)
