"""The harness on the CPU: every cell resolves from BENCHMARK.json, a cell
added as files and entries alone is found and runs, the metric arithmetic,
the seeded generators, and the last line's keys."""

from __future__ import annotations

import re
import subprocess
import sys

from typing import NamedTuple

import numpy as np
import pytest

import bench_copy

sys.path.insert(0, bench_copy.ROOT)

from stwo_bench.harness import circuit, corrupt, registry, stats, trace as trace_mod  # noqa: E402

BENCH = registry.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def copy_root(tmp_path_factory):
    return bench_copy.make_copy(str(tmp_path_factory.mktemp("bench")))


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for e in BENCH[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert "mfu" not in m["name"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    for w in BENCH["workloads"]:
        reported = registry.metrics_of(BENCH, w["name"], per_layer=False)
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
        assert registry.metrics_of(BENCH, w["name"], per_layer=True)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    w = registry.workload(BENCH, cell)
    config = registry.config(BENCH, w["config"])
    traffic = registry.traffic(w["traffic"])
    assert hasattr(registry.driver(traffic["driver"]), "Session")
    for per_layer in (False, True):
        for m in registry.metrics_of(BENCH, cell, per_layer):
            assert callable(registry.reader(m["name"]))
    assert config["log_size_plonk"] and config["public_inputs"]


def test_added_cell_is_found_without_an_edit(copy_root):
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from stwo_bench.harness import registry; "
            "b = registry.load_benchmark(); print([w['name'] for w in b['workloads']]); "
            "[registry.driver(registry.traffic(w['traffic'])['driver']) for w in b['workloads']]")
    out = subprocess.run([sys.executable, "-c", code, copy_root], capture_output=True, text=True, check=True)
    listed = eval(out.stdout.strip())  # noqa: S307 - the list this test's own subprocess printed
    assert listed == [w["name"] for w in BENCH["workloads"]] + list(bench_copy.TINY_CELLS)


@pytest.mark.parametrize("cell", list(bench_copy.TINY_CELLS))
def test_added_cell_runs_on_the_cpu(copy_root, cell):
    out = bench_copy.run_cpu(copy_root, cell)
    assert out["correct"] is True and out["failed"] == 0 and out["forbidden"] == []
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-2] == "compared"  # `forbidden` is the test's own
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}


def test_rate_is_all_work_over_the_window():
    read = registry.reader("verify_proofs_per_s")
    assert read({"kind": "verify", "proofs": 3000, "window_s": 1.5}) == 2000.0
    assert read({"kind": "prove", "proofs": 3, "window_s": 1.5}) is None
    assert registry.reader("prove_s")({"kind": "prove", "units": 4, "window_s": 10.0}) == 2.5


def test_p95_is_over_every_batch():
    values = [float(v) for v in range(1, 101)]
    assert stats.p95(values) == 95.0
    assert stats.p95(values[::-1]) == 95.0
    assert stats.p95([7.0]) == 7.0
    read = registry.reader("verify_p95_ms")
    assert read({"kind": "verify", "latencies_s": [0.001 * v for v in range(1, 201)]}) == pytest.approx(190.0)


class _Event:
    def __init__(self, name, start, dur, cuda):
        self._n, self._s, self._d, self._c = name, start, dur, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._c else DeviceType.CPU


def test_idle_comes_from_the_union_of_device_intervals():
    events = [_Event("bench#call", 0, 1000, False), _Event("bench#call", 0, 1000, True),
              _Event("k1", 100, 200, True), _Event("k2", 200, 200, True), _Event("Memcpy HtoD", 700, 100, True),
              _Event("aten::add", 500, 150, False)]
    tr = trace_mod.Trace(events)
    assert (tr.lo, tr.hi) == (0, 1000)
    assert tr.busy_s == pytest.approx(400e-9)  # [100, 400) and [700, 800); the annotation is no operation
    assert tr.kernel_s == pytest.approx(400e-9)
    read = registry.reader("verify.device_idle")
    assert read({"kind": "verify", "trace": tr}) == pytest.approx(60.0)
    gaps = dict(tr.idle_by_host())
    assert gaps["call / aten::add"] == pytest.approx(300e-9)  # [400, 700) mid 550
    assert stats.gaps([(1, 3), (2, 4), (6, 7)], 0, 8) == [(0, 1), (4, 6), (7, 8)]


def _fixture_proof():
    from stwo_bench.reference.proof.parse import parse_plonk_with_poseidon_proof

    config = registry.config(BENCH, "recursive_16_15")
    with open(f"{bench_copy.ROOT}/{config['proof']}", "rb") as f:
        return parse_plonk_with_poseidon_proof(f.read())


def test_generators_are_deterministic():
    proof = _fixture_proof()
    one = corrupt.draw(np.random.Generator(np.random.PCG64(2**31 + 5)), proof, 64, 16, 3)
    two = corrupt.draw(np.random.Generator(np.random.PCG64(2**31 + 5)), proof, 64, 16, 3)
    other = corrupt.draw(np.random.Generator(np.random.PCG64(6)), proof, 64, 16, 3)
    assert one == two and one != other
    assert {kind for p in one for _, kind, _, _ in p} == set(corrupt.KINDS)
    a = circuit.seeded_trace(8, 8, circuit.trace_rng(2**31 + 9, 0))
    b = circuit.seeded_trace(8, 8, circuit.trace_rng(2**31 + 9, 0))
    c = circuit.seeded_trace(8, 8, circuit.trace_rng(2**31 + 9, 1))
    assert circuit.digest(a) == circuit.digest(b) != circuit.digest(c)


def test_level12_trace_digest_is_pinned():
    config = registry.config(BENCH, "chain_level12")
    trace = circuit.seeded_trace(config["log_size_plonk"], config["log_size_poseidon"], circuit.trace_rng(0, 0))
    assert circuit.digest(trace) == config["trace_sha256_seed0"]
    assert len(trace["a_wire"]) == 1 << config["log_size_plonk"]


class _Arrays(NamedTuple):
    samples_flat: np.ndarray
    nonce_limbs: np.ndarray


def test_plant_keeps_values_canonical():
    pa = corrupt.tiled(_Arrays(np.zeros((1, 30, 4), np.uint32), np.zeros((1, 3), np.uint32)), 2)
    pa.samples_flat[1, 3, 2] = corrupt.P - 1
    corrupt.plant(pa, 1, [(("samples_flat",), (3, 2), corrupt.P)], 5)
    assert pa.samples_flat[1, 3, 2] == 4 and pa.samples_flat[0].sum() == 0
    corrupt.plant(pa, 0, [(("nonce_limbs",), (0,), 1 << 22)], (1 << 22) - 1)
    assert pa.nonce_limbs[0, 0] == (1 << 22) - 1
    corrupt.plant(pa, 0, [(("nonce_limbs",), (0,), 1 << 22)], 2)
    assert pa.nonce_limbs[0, 0] == 1


@pytest.mark.parametrize("kind", corrupt.KINDS)
def test_reference_plants_each_kind_in_its_own_proof(kind):
    from stwo_bench.reference.check_verify import corrupted
    from stwo_bench.reference.verifier import stark

    proof = _fixture_proof()
    pattern = next(c for p in corrupt.draw(np.random.Generator(np.random.PCG64(2**31 + 1)), proof, 64, 4, 1)
                   for c in p if c[1] == kind)
    _, _, where, delta = pattern
    moved = corrupted(proof, kind, where, delta)
    before, after = stark.flat_samples(proof), stark.flat_samples(moved)
    fri, fri2 = proof.stark_proof.fri_proof, moved.stark_proof.fri_proof
    changed = {
        "sampled_value": int((before != after).sum()),
        "first_layer_witness": int((fri.first_layer.fri_witness != fri2.first_layer.fri_witness).sum()),
        "inner_layer_witness": sum(int((np.asarray(a.decommitment.hash_witness) != np.asarray(b.decommitment.hash_witness)).sum())
                                   for a, b in zip(fri.inner_layers, fri2.inner_layers)),
        "nonce": int(proof.stark_proof.proof_of_work != moved.stark_proof.proof_of_work),
    }
    assert changed[kind] == 1 and sum(changed.values()) == 1
    assert int(after.max()) < corrupt.P
