"""The port's SHA-256 fast paths (composition on the CPU) against the JAX
package's own fast paths, at tolerance 0, the whole dict, key order
included: the bitcoin one (verify_sha256np) clean, with a corrupted
first-layer FRI witness and with one wrong public input; the level-14 one
(verify_sha256p31) clean, with a corrupted sampled value and with one wrong
public input.  The JAX fast paths jit their composition on the CPU backend
(about 30 s a flavour, once per process), so these cases sit in a file of
their own; tests/test_torch_sha256.py holds both fast paths to the JAX host
verifiers."""

import pytest

from recursive_stwo_tpu.verifier import verify_sha256 as r_vs
from recursive_stwo_tpu_torch.models import flagship
from recursive_stwo_tpu_torch.verifier import verify_sha256 as t_vs

from test_torch_sha256 import P, _corruptions, _inputs, _reference_artifact, _same

CASES = [("clean", None, None)] + _corruptions("bitcoin")


def _wrong_input(kind):
    wrong = list(_inputs(kind))
    idx, val = wrong[1]
    wrong[1] = (idx, ((val[0] + 1) % P,) + val[1:])
    return tuple(wrong)


LEVEL14_CASES = [("clean", None, None)] + _corruptions("level14") + [("public input", None, _wrong_input("level14"))]


def _hold(kind, corrupt, inputs, label):
    ref_proof, proof = _reference_artifact(kind), flagship.sha_artifact(kind)
    if corrupt:
        corrupt(ref_proof)
        corrupt(proof)
    inputs = inputs or _inputs(kind)
    ref = getattr(r_vs, f"verify_{'sha256p31' if kind == 'level14' else 'sha256np'}")(ref_proof, inputs)
    got = getattr(t_vs, f"verify_{'sha256p31' if kind == 'level14' else 'sha256np'}")(proof, inputs, device="cpu")
    _same(ref, got)
    assert bool(got["ok"][0]) == (label == "clean")
    return got


@pytest.mark.parametrize("label,corrupt,inputs", CASES, ids=[c[0] for c in CASES])
def test_bitcoin_fast_path_matches_reference_fast_path(label, corrupt, inputs):
    _hold("bitcoin", corrupt, inputs, label)


@pytest.mark.parametrize("label,corrupt,inputs", LEVEL14_CASES, ids=[c[0] for c in LEVEL14_CASES])
def test_level14_fast_path_matches_reference_fast_path(label, corrupt, inputs):
    got = _hold("level14", corrupt, inputs, label)
    if label == "public input":
        assert [k for k, v in got.items() if not v[0]] == ["total_sum", "ok"]
