"""The SHA-256 flavours' device checks and fast paths, on torch tensors.

Twin of the device half of recursive_stwo_tpu/verifier/verify_sha256.py.
The SHA-256 transcript replay and the Merkle root recomputation stay on the
host (verify_sha256_host.py; the native AVX-512 kernels inside
hints.prepare, whose path expansion asserts root equality down to the last
layer).  What runs on the device is everything but SHA-256 hashing:

- `device_checks_p31` / `device_checks_np`: pow, total-sum, the composition
  AIR at the OODS point, the quotients and the FRI fold chain (the same
  `fold_phase` the Poseidon31 verifier runs) over a batch, with a batch of
  host-made FSOutputs (`tile_fs`);
- `verify_sha256p31` / `verify_sha256np`: one proof, host transcript, path
  expansion, pow and total sum, and the composition check on `device`.  The
  JAX package pins that batch-1 check to its CPU backend; here the caller
  chooses, and the default is the card.  Nothing falls back to the CPU.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..core import qm31 as q
from ..core import qm31_host
from ..core.qm31 import QM31
from . import composition as composition_mod
from . import hints as hints_mod
from . import points, sha256_merkle, transcript
from .arrays import from_proofs_np, require_device
from .spec import NoPoseidonVerifierSpec, VerifierSpec
from .transcript import _q_cols, input_sum, is_zero
from .transcript_host import FSOutput
from .verify import fold_phase, with_ok
from .verify_sha256_host import (
    _input_sum as _host_input_sum,
    composition_on,
    run_transcript_sha256np,
    run_transcript_sha256p31,
)

Inputs = Sequence[Tuple[int, Tuple[int, int, int, int]]]


def _map_tree(fn, x):
    """fn on every array of a tree of tuples and NamedTuples."""
    if isinstance(x, tuple):
        parts = [_map_tree(fn, v) for v in x]
        return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
    return fn(x)


def tile_fs(fs: FSOutput, batch: int, device) -> FSOutput:
    """A batch-1 host FSOutput (numpy uint32) -> `batch` copies as int64
    tensors on `device`; `fri_alphas`, a tuple of QM31s, is mapped as a
    tree."""
    return _map_tree(
        lambda x: torch.from_numpy(
            np.broadcast_to(np.asarray(x), (batch,) + np.asarray(x).shape[1:]).astype(np.int64)
        ).to(device),
        fs,
    )


def device_checks_p31(spec: VerifierSpec, pa, fs: FSOutput, inputs: Inputs) -> dict:
    """Batch checks for Sha256Poseidon31 PlonkWithPoseidon proofs (no
    Merkle hashing: roots were enforced during host preparation)."""
    checks = {"pow": transcript.pow_check(spec, fs)}
    plonk_sum = _q_cols(pa.plonk_total_sum)
    poseidon_sum = _q_cols(pa.poseidon_total_sum)
    checks["total_sum"] = is_zero(q.q_add(q.q_add(input_sum(fs, inputs), plonk_sum), poseidon_sum))
    oods = points.oods_point_from_t(fs.oods_t)
    checks["composition"] = composition_mod.composition_check(
        spec, pa.samples_flat, plonk_sum, poseidon_sum,
        (fs.z, fs.alpha), fs.random_coeff, oods,
    )
    checks.update(fold_phase(spec, pa, fs, oods)[0])
    return with_ok(checks)


def device_checks_np(spec: NoPoseidonVerifierSpec, pa, fs: FSOutput, inputs: Inputs) -> dict:
    """Batch checks for Sha256MerkleChannel PlonkWithoutPoseidon proofs —
    the bitcoin_proof shape (FRI(0,9,8), 264 public inputs)."""
    checks = {"pow": transcript.pow_check(spec, fs)}
    total_sum = _q_cols(pa.plonk_total_sum)
    checks["total_sum"] = is_zero(q.q_add(input_sum(fs, inputs), total_sum))
    oods = points.oods_point_from_t(fs.oods_t)
    checks["composition"] = composition_mod.composition_check_np(
        spec, pa.samples_flat, total_sum,
        (fs.z, fs.alpha), fs.random_coeff, oods,
    )
    checks.update(fold_phase(spec, pa, fs, oods)[0])
    return with_ok(checks)


def _fast_path(spec, proof, fs: FSOutput, inputs: Inputs, device) -> dict:
    """Host path expansion (root-asserting), host pow and total sum, and the
    composition check on `device`; the dict of the JAX fast paths."""
    np_flavor = isinstance(spec, NoPoseidonVerifierSpec)
    checks = {}
    try:
        pa = hints_mod.prepare(
            spec, [proof],
            **({"arrays_fn": from_proofs_np} if np_flavor else {}),
            transcript_fn=lambda s, p: fs,
            hash_node_fn=sha256_merkle.hash_node,
        )
        checks["merkle_fri"] = np.array([True])
    except AssertionError:
        return {"ok": np.array([False]), "merkle_fri": np.array([False])}

    checks["pow"] = (fs.pow_digest0 & np.uint32((1 << spec.pow_bits) - 1)) == 0
    sums = [QM31(*(pa.plonk_total_sum[:, i] for i in range(4)))]
    if not np_flavor:
        sums.append(QM31(*(pa.poseidon_total_sum[:, i] for i in range(4))))
    total = _host_input_sum(fs, inputs)
    for s in sums:
        total = qm31_host.q_add(total, s)
    checks["total_sum"] = (total.a == 0) & (total.b == 0) & (total.c == 0) & (total.d == 0)
    checks["composition"] = composition_on(spec, pa.samples_flat, sums, fs, device).cpu().numpy()
    return with_ok(checks)


def verify_sha256p31(proof, inputs: Inputs = (), device="cuda") -> dict:
    """Fast-path verification of one Sha256Poseidon31 proof: host SHA
    transcript + native path expansion (which asserts every Merkle root
    and the full FRI fold chain down to the last-layer polynomial), host
    pow + total-sum, and the composition check on `device`."""
    device = require_device(device)
    spec = VerifierSpec.from_proof(proof)
    return _fast_path(spec, proof, run_transcript_sha256p31(spec, proof), inputs, device)


def verify_sha256np(proof, inputs: Inputs = (), device="cuda") -> dict:
    """Fast-path verification of one Sha256MerkleChannel
    PlonkWithoutPoseidon proof (bitcoin_proof): same split as
    verify_sha256p31."""
    device = require_device(device)
    spec = NoPoseidonVerifierSpec.for_rows(proof.log_size, proof.config)
    spec.validate(proof)
    return _fast_path(spec, proof, run_transcript_sha256np(spec, proof), inputs, device)

