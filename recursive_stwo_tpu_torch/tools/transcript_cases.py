"""Inputs of the transcript kernel at the port's shapes, for the tests,
chip_smoke.py and tools/kernel_times.py.

  transcript_case(name, batch, device, corrupt=False, inputs=None)
      one of TRANSCRIPT_FIXTURES (verify_batch's two fixtures, verify_batch_np's
      np_small) tiled to `batch` proofs on `device`, with the fixture's
      public inputs unless `inputs` is given; `corrupt` changes two slots
      (CORRUPTIONS: a nonce limb, a commitment word)
  random_transcript_case(name, batch, seed, device)
      the fixture's shapes with random canonical commitments, total sums,
      samples, FRI roots, last-layer coefficients and nonce limbs, and random
      public inputs, one of which is planted so that its term
      val + alpha idx - z is zero in slot 0 (its inverse is 0)
  replay_fields(case, plain=False) -> {name: tensor}
      every output of the transcript kernel on a CUDA case (or with `plain`
      the plain version), QM31s split by limb: each FSOutput field, the
      OODS point, the input sum and the two checks
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models import flagship
from ..verifier import transcript
from ..verifier.arrays import to_torch

P = 2**31 - 1
# the fixtures of verify_batch and verify_batch_np
TRANSCRIPT_FIXTURES = ("small_proof", "recursive_proof_16_15", "np_small")
# what `corrupt` changes, one slot each (taken modulo the batch)
CORRUPTIONS = ("nonce limb", "commitment word")
CORRUPT_SLOTS = (1, 2)
N_RANDOM_INPUTS = 5
# the ProofArrays fields the transcript reads
TRANSCRIPT_FIELDS = ("commitments", "plonk_total_sum", "poseidon_total_sum", "samples_flat", "first_layer_commitment",
                     "inner_commitments", "last_poly", "nonce_limbs")


class TranscriptCase(NamedTuple):
    spec: object
    pa: object  # ProofArrays of int64 tensors
    inputs: tuple  # ((index, (four limbs)), ...)


def _batch1(name: str) -> tuple:
    """(spec, numpy ProofArrays of batch 1, the fixture's public inputs)."""
    if name == "np_small":
        spec, pa = flagship.prepared_arrays_np(name)
        return spec, pa, flagship.NP_FIXTURE_INPUTS[name]
    if name not in TRANSCRIPT_FIXTURES:
        raise ValueError(f"unknown fixture {name!r}, expected one of {TRANSCRIPT_FIXTURES}")
    spec, pa = flagship.prepared_arrays(name)
    return spec, pa, flagship.FIXTURE_INPUTS[name]


def transcript_case(name: str, batch: int, device, corrupt: bool = False, inputs=None) -> TranscriptCase:
    spec, pa1, fixture_inputs = _batch1(name)
    pa = flagship.tiled_batch(pa1, batch)
    if corrupt and batch:
        s_nonce, s_commit = (s % batch for s in CORRUPT_SLOTS)
        nonce, commitments = pa.nonce_limbs.copy(), pa.commitments.copy()
        nonce[s_nonce, 0] ^= np.uint32(1)
        commitments[s_commit, 1, 3] = (int(commitments[s_commit, 1, 3]) + 1) % P
        pa = pa._replace(nonce_limbs=nonce, commitments=commitments)
    return TranscriptCase(spec, to_torch(pa, device), tuple(fixture_inputs if inputs is None else inputs))


def random_transcript_case(name: str, batch: int, seed: int, device) -> TranscriptCase:
    spec, pa1, _ = _batch1(name)
    rng = np.random.default_rng(seed)
    read = {name: rng.integers(0, P, (batch,) + getattr(pa1, name).shape[1:]) for name in TRANSCRIPT_FIELDS}
    read["nonce_limbs"] = rng.integers(0, 1 << 21, (batch, 3))
    pa = flagship.tiled_batch(pa1, batch)._replace(**read)
    inputs = [(int(i), tuple(int(v) for v in rng.integers(0, P, 4))) for i in rng.integers(0, P, N_RANDOM_INPUTS)]
    # plant an input whose term is zero in slot 0: val = z - alpha idx there
    host = to_torch(pa, "cpu")
    fs = transcript.replay_plain(spec, host, ()).fs
    idx = inputs[0][0]
    val = tuple((int(z[0]) - int(a[0]) * idx) % P for z, a in zip(fs.z, fs.alpha))
    inputs[1] = (idx, val)
    return TranscriptCase(spec, to_torch(pa, device), tuple(inputs))


def fields(r) -> dict:
    """A Replay's tensors by name, QM31s split by limb."""
    out = {}

    def put(name, v):
        if isinstance(v, tuple) and v and isinstance(v[0], tuple):
            for i, x in enumerate(v):
                put(f"{name}{i}", x)
        elif isinstance(v, tuple):
            for c, x in zip("abcd", v):
                out[f"{name}.{c}"] = x
        else:
            out[name] = v

    for name, v in r.fs._asdict().items():
        put(name, v)
    put("oods_x", r.oods[0])
    put("oods_y", r.oods[1])
    put("input_sum", r.input_sum)
    out["pow"], out["total_sum"] = r.pow, r.total_sum
    return out


def replay_fields(case: TranscriptCase, plain: bool = False) -> dict:
    if plain:
        return fields(transcript.replay_plain(case.spec, case.pa, case.inputs))
    from ..ops import transcript_cuda

    return fields(transcript_cuda.replay(case.spec, case.pa, case.inputs))
