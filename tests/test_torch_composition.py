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

The domain kernel's arithmetic: a numpy model of its weighted-sum sink (the
wrapper's power table, each emitted constraint times rc^(n-1-i) in four lazy
64-bit limb sums, the 1/vanishing and acc rc^n once a point) must give the
plain version's Horner fold on the demo circuits' tables, first and
accumulating; its bound (`domain_ops`) counts that least form, below the
Horner count and, for the plonk AIR, equal to a count by hand.

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


def _sink_model(call, acc, lookup, rc) -> torch.Tensor:
    """The domain kernel on one table, in numpy: each constraint the AIR
    emits (unscaled) times rc^(n-1-i) from the wrapper's power table, summed
    per point in four 64-bit limb sums as csrc/composition_air.cuh
    `PowerSum` keeps them (an M31-valued constraint's four products, another
    constraint's canonical QM31 product; every third constraint folded below
    2^62 + 4), reduced, times the point's 1/vanishing, plus acc rc^n unless
    `first`."""
    from recursive_stwo_tpu_torch.prover import composition as p_comp

    emitted = []

    class Record:
        def append(self, block):
            cols = [np.asarray(c).reshape(c.shape[0], -1).astype(np.uint64) for c in block]
            emitted.extend([tuple(c[:, k] for c in cols) for k in range(cols[0].shape[1])])

    ones = torch.ones_like(call.denom_inv)
    call.evaluate_fn(p_comp._ProverEval(call.pre, call.tr, call.inter, call.perm, call.total, ones, call.log,
                                        Record()), lookup)
    air = composition_cuda.air_id(call.evaluate_fn)
    n = composition_cuda.domain_constraints(air)
    assert len(emitted) == n == sum(1 for comp, _, _ in composition_cuda.constraint_order(
        composition_cuda.WITHOUT_POSEIDON if air == composition_cuda.PLONK_NP else composition_cuda.WITH_POSEIDON)
        if comp == (air == composition_cuda.POSEIDON))
    pw = composition_cuda.domain_powers(rc, n)
    sums = [np.zeros(call.pre.shape[1], dtype=np.uint64) for _ in range(4)]
    for i, c in enumerate(emitted):
        p = pw[n - 1 - i]
        m31 = (c[1] == 0) & (c[2] == 0) & (c[3] == 0)
        full = r_q.q_mul(RQM31(*(x.astype(np.uint32) for x in c)), RQM31(*(np.uint32(x) for x in p)))
        for k in range(4):
            term = np.where(m31, c[0] * np.uint64(p[k]), np.asarray(full[k]).astype(np.uint64))
            new = sums[k] + term
            assert np.all(new >= sums[k]), "a 64-bit limb sum overflowed"
            sums[k] = new
        if (i + 1) % 3 == 0:
            sums = [(s & np.uint64((1 << 62) - 1)) + (s >> np.uint64(62)) for s in sums]
    P = np.uint64(2**31 - 1)
    value = RQM31(*(np.asarray([int(x) % (2**31 - 1) for x in s], dtype=np.uint32) for s in sums))
    value = r_q.q_mul_m31(value, call.denom_inv.numpy().astype(np.uint32))
    if not call.first:
        value = r_q.q_add(r_q.q_mul(RQM31(*(a.numpy().astype(np.uint32) for a in acc)),
                                    RQM31(*(np.uint32(x) for x in pw[n]))), value)
    assert all(int(np.max(np.asarray(v))) < P for v in value)
    return torch.from_numpy(np.stack([np.asarray(v).astype(np.int64) for v in value]))


@pytest.mark.parametrize("circuit", ["demo", "without-Poseidon demo"])
def test_weighted_domain_sink_reproduces_the_plain_evals(circuit):
    """The domain kernel's weighted sum, modelled in numpy with the power
    table the wrapper passes, equals the plain version's Horner fold table by
    table: each table as the first and accumulating into a random previous
    accumulator, and over all tables `composition_evals_plain`."""
    from test_torch_chain import T_NP_CONFIG, _np_trace

    from recursive_stwo_tpu_torch.models import flagship
    from recursive_stwo_tpu_torch.prover import composition as p_comp

    if circuit == "demo":
        trace, config = flagship.demo_trace(), flagship.DEMO_CONFIG
    else:
        trace, config = _np_trace(), T_NP_CONFIG
    spec, tables, lookup, rc = cases.prover_tables(trace, config, "cpu", circuit.startswith("without"))
    calls = cases.domain_calls(spec, tables)
    assert [c.first for c in calls] == [True] + [False] * (len(calls) - 1)
    assert len(calls) == (1 if circuit.startswith("without") else 2)
    acc = torch.zeros((4, 1 << spec.composition_log_degree_bound), dtype=torch.int64)
    rng = np.random.default_rng(5)
    for call in calls:
        want = cases.run_domain(call, acc, lookup, rc, plain=True)
        assert torch.equal(_sink_model(call, acc, lookup, rc), want)
        prev = torch.from_numpy(rng.integers(0, 2**31 - 1, tuple(acc.shape)))
        onto = call._replace(first=False)
        assert torch.equal(_sink_model(onto, prev, lookup, rc),
                           cases.run_domain(onto, prev, lookup, rc, plain=True))
        acc = want
    assert torch.equal(acc, p_comp.composition_evals_plain(spec, tables, lookup, rc))


def test_domain_ops_counts_the_weighted_sum():
    """The domain kernel's bound counts the combination at its least form:
    below the Horner fold's count for every AIR, and for the plonk AIR equal
    to a count by hand (composition_air.cuh's evaluate_plonk on M31 rows; a
    modular add 3, a product 6, a product or add with a limb known zero
    free)."""
    for air in (composition_cuda.PLONK, composition_cuda.POSEIDON, composition_cuda.PLONK_NP):
        for first in (True, False):
            o = composition_cuda._Ops()
            acc = composition_cuda._Z if first else composition_cuda._Q
            composition_cuda._component_ops(o, air, acc, composition_cuda._M, False, composition_cuda._M)
            assert composition_cuda.domain_ops(air, first) < o.int_ops, (air, first)
    add, mul = 3, 6
    qq = 16 * mul + 16 * add  # a QM31 x QM31 product
    mq = 4 * mul  # an M31 x QM31 product
    qa = 4 * add  # a QM31 add or sub
    hand = (
        mq  # the cumsum shift, total sum x 1 / 2^log_size
        + 3 * (mul + mq) + 2 * qa  # enforce_c_m31: an M31 product each, weighted, summed (the first into zero)
        + qa + mq + qa + add + mq + qq + qa  # the gate (a QM31 value: the wires combined)
        + qq + qa  # its weighted add
        + 3 * (mq + qa + qa)  # three relations a + alpha wire - z
        + add + qq + add + qq + qq + qa + qa  # the fourth: -mult, a 3-value relation and alpha^2
        + 2 * (2 * mq + qa + qq)  # each batch's fraction p / q folded
        + qq + qa + qq + qa  # batch 0's emitted value, weighted and added
        + 3 * qa + qq + qa + qq + qa  # batch 1 against the previous and current row
        + mq  # the sum times 1/vanishing, once
    )
    assert composition_cuda.domain_ops(composition_cuda.PLONK, True) == hand == 2223
    assert composition_cuda.domain_ops(composition_cuda.PLONK, False) == hand + qq + qa
