"""The port's PlonkWithoutPoseidon verifier against the JAX package's, at
tolerance 0: on the Poseidon31 channel (np_small: the transcript, the
composition check and the whole verify_batch_np, reference on numpy
ProofArrays), and the SHA-256 channel's bitcoin proof (device_checks_np,
reference un-jitted on jax.numpy arrays on the CPU backend).  Every named
check of every slot is compared, and so is the key order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recursive_stwo_tpu.core.qm31 import QM31 as RQM31
from recursive_stwo_tpu.verifier import composition as r_comp
from recursive_stwo_tpu.verifier import points as r_points
from recursive_stwo_tpu.verifier import transcript as r_tr
from recursive_stwo_tpu.verifier.verify_np import verify_batch_np as r_verify_np
from recursive_stwo_tpu_torch.core.qm31 import QM31
from recursive_stwo_tpu_torch.models import flagship
from recursive_stwo_tpu_torch.verifier import composition as t_comp
from recursive_stwo_tpu_torch.verifier import points as t_points
from recursive_stwo_tpu_torch.verifier import transcript as t_tr
from recursive_stwo_tpu_torch.verifier.arrays import map_arrays, to_torch
from recursive_stwo_tpu_torch.verifier.verify_np import verify_batch_np as t_verify_np

from test_torch_sha256_device import _same_checks, device_checks_case
from test_torch_transcript import _compare

INPUTS = flagship.NP_FIXTURE_INPUTS["np_small"]
SIB_SLOT, NONCE_SLOT, SAMPLE_SLOT = 1, 2, 3


def _batch(B=4, corrupt=True):
    spec, pa = flagship.prepared_arrays_np("np_small")
    pa = flagship.tiled_batch(pa, B)
    if corrupt:
        pa.tree_paths[1].sibling_hashes[SIB_SLOT, 0, 0, 0] ^= np.uint32(1)
        pa.nonce_limbs[NONCE_SLOT] ^= np.uint32(1)
        pa.samples_flat[SAMPLE_SLOT, 0, 0] ^= np.uint32(1)
    return spec, pa


def _failing(checks, slot):
    return sorted(k for k, v in checks.items() if not v[slot])


@pytest.mark.parametrize("corrupt", [False, True])
def test_run_transcript_np_matches_reference(corrupt):
    spec, pa = _batch(corrupt=corrupt)
    got = t_tr.run_transcript_np(spec, to_torch(pa, "cpu"))
    ref = r_tr.run_transcript_np(spec, pa)
    _compare(ref, got)
    assert np.array_equal(np.asarray(r_tr.pow_check(spec, ref)), t_tr.pow_check(spec, got).numpy())


def test_run_transcript_np_matches_jnp_reference():
    spec, pa = _batch(B=2, corrupt=False)
    _compare(r_tr.run_transcript_np(spec, map_arrays(jnp.asarray, pa)), t_tr.run_transcript_np(spec, to_torch(pa, "cpu")))


def test_composition_check_np_matches_reference():
    """The composition check alone, on the transcript's own draws, with a
    sampled value flipped in one slot (which moves no draw here)."""
    spec, pa = _batch(corrupt=False)
    fs = r_tr.run_transcript_np(spec, pa)
    pa.samples_flat[SAMPLE_SLOT, 5, 2] ^= np.uint32(1)
    total = RQM31(*(pa.plonk_total_sum[:, i] for i in range(4)))
    ref = r_comp.composition_check_np(
        spec, pa.samples_flat, total, (fs.z, fs.alpha), fs.random_coeff, r_points.oods_point_from_t(fs.oods_t)
    )

    def t(x):
        return torch.from_numpy(np.asarray(x).astype(np.int64))

    def tq(x):
        return QM31(*(t(c) for c in x))

    got = t_comp.composition_check_np(
        spec, t(pa.samples_flat), tq(total), (tq(fs.z), tq(fs.alpha)), tq(fs.random_coeff),
        t_points.oods_point_from_t(tq(fs.oods_t)),
    )
    assert np.array_equal(np.asarray(ref), got.numpy())
    assert got.tolist() == [True, True, True, False]


def test_verify_batch_np_matches_reference():
    spec, pa = _batch()
    checks = _same_checks(r_verify_np(spec, pa, INPUTS), t_verify_np(spec, to_torch(pa, "cpu"), INPUTS))
    assert _failing(checks, 0) == []
    assert _failing(checks, SIB_SLOT) == ["ok", "tree1"]
    assert not checks["pow"][NONCE_SLOT] and not checks["ok"][NONCE_SLOT]
    assert not checks["ok"][SAMPLE_SLOT]


def test_verify_batch_np_wrong_input_fails_total_sum():
    spec, pa = _batch(B=2, corrupt=False)
    wrong = ((1, (2, 0, 0, 0)),) + INPUTS[1:]
    checks = _same_checks(r_verify_np(spec, pa, wrong), t_verify_np(spec, to_torch(pa, "cpu"), wrong))
    assert _failing(checks, 0) == _failing(checks, 1) == ["ok", "total_sum"]


def test_verifier_step_np_accepts_on_cpu():
    step, arrays = flagship.verifier_step_np("np_small", 2, device="cpu")
    assert bool(step(arrays)["ok"].all())


def test_verifier_step_np_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        flagship.verifier_step_np("np_small", 1, device="cuda")


def test_device_checks_np_matches_reference():
    """The bitcoin proof's device checks (264 public inputs) per slot."""
    device_checks_case("bitcoin")
