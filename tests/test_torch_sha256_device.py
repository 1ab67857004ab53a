"""The SHA-256 flavours' device checks against the JAX package's, at
tolerance 0: device_checks_p31 on chain level 14's artifact here, and
device_checks_np on the bitcoin proof in tests/test_torch_np.py (each file
stays near 30 s: the reference runs un-jitted on jax.numpy arrays on the
CPU backend, where one call takes about 20 s).  Every named check of every
slot is compared, and so is the key order."""

import jax
import jax.numpy as jnp
import numpy as np

from recursive_stwo_tpu.verifier import verify_sha256 as r_vs
from recursive_stwo_tpu_torch.models import flagship
from recursive_stwo_tpu_torch.verifier import verify_sha256 as t_vs
from recursive_stwo_tpu_torch.verifier.arrays import to_torch


def _same_checks(ref, got):
    """{key: bool numpy array} after asserting equal keys, order and values."""
    assert list(ref) == list(got)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = {k: v.cpu().numpy() for k, v in got.items()}
    for k in ref:
        assert got[k].dtype == bool and np.array_equal(ref[k], got[k]), k
    return got


def device_checks_case(kind, inputs=None):
    """(reference checks, port checks) of the SHA flavour's device checks
    over 3 copies of an artifact: slot 1 with a flipped sampled value, slot
    2 with a flipped pow_digest0.  The reference is the un-jitted JAX
    function on jax.numpy arrays on the CPU backend."""
    spec, pa1, fs1 = flagship.sha_prepared(kind)
    inputs = flagship.sha_inputs(kind) if inputs is None else inputs
    pa = flagship.tiled_batch(pa1, 3)
    pa.samples_flat[1, 0, 0] ^= np.uint32(1)
    fs = r_vs._tile_fs(fs1, 3)
    fs.pow_digest0[2] ^= np.uint32(1)
    r_fn = r_vs.device_checks_np if kind == "bitcoin" else r_vs.device_checks_p31
    with jax.default_device(jax.devices("cpu")[0]):
        ref = r_fn(spec, jax.tree.map(jnp.asarray, pa), jax.tree.map(jnp.asarray, fs), inputs)
    t_fn = t_vs.device_checks_np if kind == "bitcoin" else t_vs.device_checks_p31
    fs_t = t_vs.tile_fs(fs1, 3, "cpu")
    fs_t.pow_digest0[2] ^= 1
    got = t_fn(spec, to_torch(pa, "cpu"), fs_t, inputs)
    checks = _same_checks(ref, got)
    assert checks["ok"].tolist() == [True, False, False]
    assert not checks["pow"][2] and checks["pow"][:2].all()
    return checks


def test_device_checks_p31_matches_reference():
    device_checks_case("level14")
