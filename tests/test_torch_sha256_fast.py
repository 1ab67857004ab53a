"""The port's bitcoin fast path (verify_sha256np, composition on the CPU)
against the JAX package's own fast path, at tolerance 0: clean, a corrupted
first-layer FRI witness, and one wrong public input; the whole dict, key
order included.  The JAX fast path jits its composition on the CPU backend
(about 30 s, once per process), so these cases sit in a file of their own;
tests/test_torch_sha256.py holds both fast paths to the JAX host verifiers."""

import pytest

from recursive_stwo_tpu.verifier import verify_sha256 as r_vs
from recursive_stwo_tpu_torch.models import flagship
from recursive_stwo_tpu_torch.verifier import verify_sha256 as t_vs

from test_torch_sha256 import _corruptions, _inputs, _reference_artifact, _same

CASES = [("clean", None, None)] + _corruptions("bitcoin")


@pytest.mark.parametrize("label,corrupt,inputs", CASES, ids=[c[0] for c in CASES])
def test_bitcoin_fast_path_matches_reference_fast_path(label, corrupt, inputs):
    ref_proof, proof = _reference_artifact("bitcoin"), flagship.sha_artifact("bitcoin")
    if corrupt:
        corrupt(ref_proof)
        corrupt(proof)
    inputs = inputs or _inputs("bitcoin")
    ref = r_vs.verify_sha256np(ref_proof, inputs)
    got = t_vs.verify_sha256np(proof, inputs, device="cpu")
    _same(ref, got)
    assert bool(got["ok"][0]) == (label == "clean")
