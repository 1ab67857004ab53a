"""The port's composition check against the JAX package's, at tolerance 0,
and the check kernel's index tables against the eager evaluator's reads.

For each verifier's fixture (small_proof, recursive_proof_16_15, np_small,
the level-14 and bitcoin artifacts) the port's plain version computes the
Horner value of every constraint per proof; the JAX package's evaluators
(`evaluate_plonk[_np]`, `evaluate_poseidon`) and `_horner`, run on numpy on
the same inputs, must give the same residues, slot by slot, with one sampled
value corrupted.  The index table that csrc/composition.cu reads samples
through must name the sample indices `_Eval._gather` visits, in its order,
then the 8 composition samples.  The kernels themselves run only on the
card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from recursive_stwo_tpu.core import qm31 as r_q
from recursive_stwo_tpu.core.qm31 import QM31 as RQM31
from recursive_stwo_tpu.verifier import composition as r_comp
from recursive_stwo_tpu.verifier import points as r_points
from recursive_stwo_tpu.verifier.spec import (
    N_INTERACTION_PLONK,
    N_PREPROCESSED_PLONK,
    N_TRACE_PLONK,
)
from recursive_stwo_tpu_torch.ops import composition_cuda
from recursive_stwo_tpu_torch.tools import composition_cases as cases
from recursive_stwo_tpu_torch.verifier import composition as t_comp
from recursive_stwo_tpu_torch.verifier.spec import NoPoseidonVerifierSpec

BATCH, CORRUPT_SLOT = 3, 1


def _np(x) -> RQM31:
    return RQM31(*(np.asarray(c).astype(np.uint32) for c in x))


def _reference_value(case: cases.CheckCase) -> RQM31:
    """The JAX package's evaluators and Horner scan on numpy."""
    spec = case.spec
    samples = case.samples_flat.numpy().astype(np.uint32)
    sums = [_np(s) for s in case.sums]
    lookup = (_np(case.lookup[0]), _np(case.lookup[1]))
    oods_x = _np(case.oods[0])
    constraints = []
    if isinstance(spec, NoPoseidonVerifierSpec):
        denom_inv = r_q.q_inv(r_points.coset_vanishing_canonic(oods_x, spec.log_size))
        ev = r_comp._Eval(spec, samples, (0, 0, 0), sums[0], denom_inv, spec.log_size, constraints)
        r_comp.evaluate_plonk_np(ev, lookup)
    else:
        denom_inv = r_q.q_inv(r_points.coset_vanishing_canonic(oods_x, spec.log_size_plonk))
        ev = r_comp._Eval(spec, samples, (0, 0, 0), sums[0], denom_inv, spec.log_size_plonk, constraints)
        r_comp.evaluate_plonk(ev, lookup)
        denom_inv = r_q.q_inv(r_points.coset_vanishing_canonic(oods_x, spec.log_size_poseidon))
        ev = r_comp._Eval(spec, samples, (N_PREPROCESSED_PLONK, N_TRACE_PLONK, N_INTERACTION_PLONK), sums[1],
                          denom_inv, spec.log_size_poseidon, constraints)
        r_comp.evaluate_poseidon(ev, lookup)
    return r_comp._horner(constraints, _np(case.random_coeff))


@pytest.mark.parametrize("name", cases.CHECK_FIXTURES)
def test_plain_value_matches_reference(name):
    case = cases.check_case(name, BATCH, "cpu", corrupt_slot=CORRUPT_SLOT)
    ok, value = cases.check_value(case)  # the dispatch takes the plain version on the CPU
    ref = _reference_value(case)
    for got, want in zip(value, ref):
        assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert ok.tolist() == [True, False, True]
    # composition_check is the value's bool, and the JAX package's check agrees
    np_flavour = len(case.sums) == 1
    check = t_comp.composition_check_np if np_flavour else t_comp.composition_check
    assert torch.equal(check(case.spec, case.samples_flat, *case.sums, case.lookup, case.random_coeff, case.oods), ok)
    r_check = r_comp.composition_check_np if np_flavour else r_comp.composition_check
    ref_ok = r_check(case.spec, case.samples_flat.numpy().astype(np.uint32), *(_np(s) for s in case.sums),
                     (_np(case.lookup[0]), _np(case.lookup[1])), _np(case.random_coeff),
                     (_np(case.oods[0]), _np(case.oods[1])))
    assert np.asarray(ref_ok).tolist() == ok.tolist()


@pytest.mark.parametrize("name", cases.CHECK_FIXTURES)
def test_index_table_names_the_evaluators_reads(name, monkeypatch):
    case = cases.check_case(name, 1, "cpu")
    visited = []
    gather = t_comp._Eval._gather

    def recording(self, idxs):
        visited.extend(int(i) for i in idxs)
        return gather(self, idxs)

    monkeypatch.setattr(t_comp._Eval, "_gather", recording)
    cases.check_value(case, plain=True)
    composition = [case.spec.sample_offsets[3][i] for i in range(composition_cuda.N_COMPOSITION_SAMPLES)]
    table = composition_cuda.index_table(case.spec)
    assert list(table) == visited + composition
    # every sample is read exactly once
    assert sorted(table) == list(range(case.spec.total_samples))


def test_unknown_evaluator_raises():
    def evaluate_other(ev, lookup):
        raise AssertionError("never evaluated")

    with pytest.raises(ValueError, match="no composition kernel"):
        composition_cuda.air_id(evaluate_other)
    z = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="no composition kernel"):
        composition_cuda.domain(evaluate_other, z, z, z, z[0], z[0], z, True, (0,) * 4, ((0,) * 4,) * 2, (0,) * 4, 1)


def test_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers raise on a CPU tensor: the plain version is
    taken by the dispatch, never by a wrapper falling back."""
    case = cases.check_case("np_small", 1, "cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        composition_cuda.check(case.spec, case.samples_flat, case.sums, case.lookup, case.random_coeff, case.oods[0])
