"""The port's composition check against the JAX package's, at tolerance 0,
and the check kernel's index tables against the eager evaluator's reads.

For each verifier's fixture (small_proof, recursive_proof_16_15, np_small,
the level-14 and bitcoin artifacts) the port's plain version computes the
Horner value of every constraint per proof; the JAX package's evaluators
(`evaluate_plonk[_np]`, `evaluate_poseidon`) and `_horner`, run on numpy on
the same inputs, must give the same residues, slot by slot, with one sampled
value corrupted.  The index table that csrc/composition.cu reads samples
through must name the sample indices `_Eval._gather` visits, in its order,
then the 8 composition samples.

The check kernel's arithmetic: its lane table (ops/composition_cuda.py
`lane_table`) must place each AIR's constraints as the reference emits them
(count, blocks and order, and the same (kind, count) table as
csrc/composition_air.cuh), and the weighted sum it implies (each constraint
times rc^(n-1-i) from a power table built as the kernel's lanes build it,
each component's partial sum times its 1/vanishing) must reproduce the JAX
package's Horner value, clean, corrupted and on random inputs.  The kernels
themselves run only on the card (tests/test_torch_cuda.py).
"""

import re
import sys
from pathlib import Path

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
AIR_HEADER = Path(composition_cuda.__file__).resolve().parent.parent / "csrc" / "composition_air.cuh"
# the kinds of the reference's blocks, in the order each AIR function emits
# its own (finalize_logup's are "logup")
_REFERENCE_KINDS = {
    "evaluate_plonk": ["enforce_c_m31"] * 3 + ["gate"],
    "evaluate_plonk_np": ["a^4 - b"] * 4 + ["gate"],
    "evaluate_poseidon": ["first round", "full round", "full round out", "partial round", "partial out"],
}


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


def _emitted(case, monkeypatch) -> list:
    """Each component's constraints as the reference emits them, unscaled
    (1/vanishing = 1): a list per component of (kind, (B,) QM31) in Horner
    order, with the component's 1/vanishing."""
    spec = case.spec
    samples = case.samples_flat.numpy().astype(np.uint32)
    sums = [_np(s) for s in case.sums]
    lookup = (_np(case.lookup[0]), _np(case.lookup[1]))
    oods_x = _np(case.oods[0])
    one = r_q.q_one(oods_x.a)
    seen = {}
    record = []

    def emitter(block):
        def emit(self, v):
            fn = sys._getframe(1).f_code.co_name
            kind = "logup" if fn == "finalize_logup" else _REFERENCE_KINDS[fn][seen.get(fn, 0)]
            seen[fn] = seen.get(fn, 0) + 1
            cols = [np.asarray(c).reshape(c.shape[0], -1) for c in v] if block else [np.asarray(c)[:, None] for c in v]
            record.extend((kind, RQM31(*(c[:, i] for c in cols))) for i in range(cols[0].shape[1]))
        return emit

    monkeypatch.setattr(r_comp._Eval, "add_constraint", emitter(False))
    monkeypatch.setattr(r_comp._Eval, "add_constraint_block", emitter(True))
    components = []
    if isinstance(spec, NoPoseidonVerifierSpec):
        airs = [(r_comp.evaluate_plonk_np, (0, 0, 0), sums[0], spec.log_size)]
    else:
        airs = [(r_comp.evaluate_plonk, (0, 0, 0), sums[0], spec.log_size_plonk),
                (r_comp.evaluate_poseidon, (N_PREPROCESSED_PLONK, N_TRACE_PLONK, N_INTERACTION_PLONK), sums[1],
                 spec.log_size_poseidon)]
    for evaluate, base, total, log_size in airs:
        record.clear()
        seen.clear()
        evaluate(r_comp._Eval(spec, samples, base, total, one, log_size, []), lookup)
        dinv = r_q.q_inv(r_points.coset_vanishing_canonic(oods_x, log_size))
        components.append((list(record), dinv))
    return components


def _kinds(blocks) -> list:
    return [kind for kind, count in blocks for _ in range(count)]


def _header_constraints() -> dict:
    """composition_air.cuh's Kind enum and its three (kind, count) tables."""
    text = AIR_HEADER.read_text()
    enum = re.search(r"enum Kind \{([^}]*)\}", text).group(1)
    kinds = [k.split("=")[0].strip() for k in enum.split(",")]
    tables = {}
    for name, air in (("kPlonkConstraints", composition_cuda.PLONK), ("kPoseidonConstraints", composition_cuda.POSEIDON),
                      ("kNpConstraints", composition_cuda.PLONK_NP)):
        body = re.search(name + r"\[\] = \{(.*?)\};", text, re.S).group(1)
        tables[air] = tuple((composition_cuda.KINDS[kinds.index(k)], int(n))
                            for k, n in re.findall(r"\{(k\w+), (\d+)\}", body))
    return kinds, tables


def test_header_constraint_table_is_the_lane_tables():
    """The (kind, count) tables the straight-line evaluators and the lane
    table share: csrc/composition_air.cuh's equals ops/composition_cuda.py's."""
    kinds, tables = _header_constraints()
    assert len(kinds) == len(composition_cuda.KINDS)
    assert tables == composition_cuda.AIR_CONSTRAINTS


@pytest.mark.parametrize("table,flavour", [("kPoseidonLanes", composition_cuda.WITH_POSEIDON),
                                           ("kNpLanes", composition_cuda.WITHOUT_POSEIDON)])
def test_header_lane_blocks_are_the_lane_table(table, flavour):
    """The check kernel's lanes, one description: csrc/composition_air.cuh's
    lane-block table (whose stages and lanes composition.cu's code takes,
    held to it by static_asserts) equals ops/composition_cuda.py's
    LANE_BLOCKS, from which the lane table weights each (stage, lane)."""
    kinds, _ = _header_constraints()
    body = re.search(table + r"\[\] = \{(.*?)\};", AIR_HEADER.read_text(), re.S).group(1)
    blocks = tuple((int(st), int(l0), int(c), composition_cuda.KINDS[kinds.index(k)], int(n))
                   for st, l0, c, k, n in re.findall(r"\{(\d+), (\d+), (\d+), (k\w+), (\d+)\}", body))
    assert blocks == composition_cuda.LANE_BLOCKS[flavour]
    composition_cuda._lane_stages(flavour)  # no (stage, lane) holds two constraints


def _device_functions(paths) -> dict:
    """Each function defined in these CUDA sources (a name, its parameter
    list and then a brace) by name: the bodies of every definition."""
    text = "\n".join(p.read_text() for p in paths)
    text = re.sub(r"//[^\n]*", "", text)
    bodies = {}
    for m in re.finditer(r"\b(\w+)\s*\(", text):
        if m.group(1) in ("if", "for", "while", "switch", "return", "sizeof", "constexpr"):
            continue
        depth, i = 1, m.end()
        while depth and i < len(text):
            depth += {"(": 1, ")": -1}.get(text[i], 0)
            i += 1
        rest = text[i:].lstrip()
        rest = rest[len("const"):].lstrip() if rest.startswith("const") else rest
        if not rest.startswith("{"):
            continue
        start = len(text) - len(rest)
        depth, j = 1, start + 1
        while depth:
            depth += {"{": 1, "}": -1}.get(text[j], 0)
            j += 1
        bodies.setdefault(m.group(1), []).append(text[start:j])
    return bodies


def _reaches(bodies: dict, roots) -> set:
    """Every name called from `roots`, through the bodies of those defined."""
    seen, todo = set(), list(roots)
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        for body in bodies.get(name, ()):
            todo += re.findall(r"\b(\w+)\s*(?:<[^<>;(){}]*>)?\s*\(", body)  # f(...) or f<T>(...)
    return seen


class _Reads(dict):
    """The latencies a floor reads, each 1 cycle at 1 GHz."""

    def __init__(self, kinds):
        super().__init__({k: 1.0 for k in kinds}, ghz=1.0)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)


@pytest.mark.parametrize("kernel", ["composition_check_kernel", "transcript_kernel"])
def test_latency_floor_prices_the_kernels_own_limb_ops(kernel):
    """Each latency floor prices its kernel's own operations: every probe kind
    the floor reads (csrc/latency.cu's step for that kind, parsed) is an
    operation the kernel reaches, and every probed operation that the
    kernel's limb arithmetic reaches (the QM31 ops of qm31.cuh for the check,
    poseidon2.cuh's quad permutation for the transcript) is one the floor
    reads, so a floor cannot be taken at another form's latency."""
    from recursive_stwo_tpu_torch.ops import latency_cuda, transcript_cuda

    csrc = AIR_HEADER.parent
    probe = (csrc / "latency.cu").read_text()
    enum = re.search(r"enum Kind \{([^}]*)\}", probe).group(1)
    names = [k.split("=")[0].strip() for k in enum.split(",")][:-1]  # less kKinds
    assert len(names) == len(latency_cuda.KINDS)
    steps = dict(re.findall(r"KIND == (k\w+)\) return (\w+)\(", probe))
    (last,) = set(names) - set(steps)
    steps[last] = re.search(r"\n  return (\w+)\(", probe[probe.index("step(uint32_t x"):]).group(1)
    probed = {latency_cuda.KINDS[names.index(n)]: fn for n, fn in steps.items()}
    lat = _Reads(latency_cuda.KINDS)
    headers = [csrc / "m31.cuh", csrc / "qm31.cuh"]
    if kernel == "transcript_kernel":
        transcript_cuda.permutation_cycles(lat)
        bodies = _device_functions(headers + [csrc / "poseidon2.cuh", csrc / "transcript.cu"])
        limb = _reaches(bodies, ["poseidon2_m31_permute_quad"])
    else:
        for name in cases.CHECK_FIXTURES:
            composition_cuda.check_cycles(cases.check_case(name, 1, "cpu").spec, lat)
        bodies = _device_functions(headers + [csrc / "composition_air.cuh", csrc / "composition.cu"])
        limb = _reaches(bodies, ["q_add", "q_sub", "q_mul", "q_inv"])
    priced = {probed[k] for k in lat.read - {"ghz"}}
    assert priced <= _reaches(bodies, [kernel]), (priced, kernel)
    assert limb & set(probed.values()) <= priced, (limb & set(probed.values()), priced)
    assert {"add", "mul"} <= priced


@pytest.mark.parametrize("name", cases.CHECK_FIXTURES)
def test_lane_table_places_the_reference_constraints(name, monkeypatch):
    """Per AIR, the reference's emitted constraints (count, kinds, order)
    are the lane table's, and every constraint is on exactly one lane of one
    stage, where the kernel computes a constraint of its kind."""
    case = cases.check_case(name, 1, "cpu")
    flavour = composition_cuda.flavour_of(case.spec)
    emitted = _emitted(case, monkeypatch)
    for (air, _), (record, _) in zip(composition_cuda.FLAVOUR_AIRS[flavour], emitted):
        assert [k for k, _ in record] == _kinds(composition_cuda.AIR_CONSTRAINTS[air])
    order = composition_cuda.constraint_order(flavour)
    assert len(order) == sum(len(r) for r, _ in emitted)
    table = composition_cuda.lane_table(case.spec)
    stages = composition_cuda._lane_stages(flavour)
    assert all(len(stage) == composition_cuda.LANES for stage in table)
    placed = {}
    for s_idx, (stage, described) in enumerate(zip(table, stages)):
        for lane, (e, d) in enumerate(zip(stage, described)):
            if e is not None:
                assert order[e[1]] == d and e[0] == d[0]
                placed[e[1]] = (s_idx, lane)
    assert sorted(placed) == list(range(len(order)))
    words = composition_cuda.lane_words(case.spec)
    assert len(words) == composition_cuda.LANES * len(table)
    assert sorted(w & 0xFFFF for w in words if w >= 0) == list(range(len(order)))


def _power_table(rc, n: int) -> list:
    """rc^e for e < n as the kernel's lanes build it: lane l takes rc^l by
    its index's bits, then each 32 more by rc^32."""
    table = [None] * n
    lanes = []
    for lane in range(composition_cuda.LANES):
        p, sq = r_q.q_one(rc.a), rc
        for bit in range(5):
            if (lane >> bit) & 1:
                p = r_q.q_mul(p, sq)
            sq = r_q.q_mul(sq, sq)
        lanes.append((p, sq))
    for base in range(0, n, composition_cuda.LANES):
        for lane, (p, sq) in enumerate(lanes):
            if base + lane < n:
                table[base + lane] = p
            lanes[lane] = (r_q.q_mul(p, sq), sq)
    return table


@pytest.mark.parametrize("variant", ["clean", "corrupted", "random"])
@pytest.mark.parametrize("name", cases.CHECK_FIXTURES)
def test_weighted_lane_sum_reproduces_the_reference_value(name, variant, monkeypatch):
    """The check kernel's sum: for each (stage, lane) of the lane table, its
    constraint times rc^(n-1-i), summed per component, each component's sum
    times its 1/vanishing once, equals the JAX package's Horner value
    (composition_check's `computed`), slot by slot."""
    case = cases.check_case(name, BATCH, "cpu", corrupt_slot=CORRUPT_SLOT if variant == "corrupted" else None)
    if variant == "random":
        case = cases.random_check_case(case.spec, BATCH, 17, "cpu")
    want = _reference_value(case)
    emitted = _emitted(case, monkeypatch)
    order = composition_cuda.constraint_order(composition_cuda.flavour_of(case.spec))
    constraint = [v for record, _ in emitted for _, v in record]
    rc = _np(case.random_coeff)
    pw = _power_table(rc, len(order))
    acc = [r_q.q_zero(rc.a) for _ in emitted]
    for stage in composition_cuda.lane_table(case.spec):
        for e in stage:
            if e is not None:
                comp, i = e
                acc[comp] = r_q.q_add(acc[comp], r_q.q_mul(constraint[i], pw[len(order) - 1 - i]))
    got = r_q.q_zero(rc.a)
    for a, (_, dinv) in zip(acc, emitted):
        got = r_q.q_add(got, r_q.q_mul(a, dinv))
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))
