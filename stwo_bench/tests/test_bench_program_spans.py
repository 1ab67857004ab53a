"""The readers of the program's spans (harness/program_spans.py and the five
metrics that use it) on synthetic traces: the card's idle time inside a
span, host time and counts with nested occurrences counted once, division
by the window's proofs or calls, and None where the spans are absent."""

from __future__ import annotations

import sys

import pytest

import bench_copy

sys.path.insert(0, bench_copy.ROOT)

from stwo_bench.harness import program_spans, registry, trace as trace_mod  # noqa: E402

PROVE = ("prove.fri_idle_s", "prove.decommit_s", "prove.host_reads")
VERIFY = ("verify.lowering_ms", "verify.fold_host_ms")


class _Event:
    def __init__(self, name, start, end, cuda=False):
        self._n, self._s, self._e, self._c = name, start, end, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._c else DeviceType.CPU


def _trace(*events):
    return trace_mod.Trace([_Event(*e) for e in events])


def _prove_trace():
    """Two proofs of 10,000 ns each: a FRI stage with 700 ns of kernels in
    its 4,000 (3,300 idle) in the first, 2,000 with none (2,000) in the
    second; decommitments of 1,500 and 2,500 ns, one nested in another of
    the same name; three reads to the host, one nested in another."""
    return _trace(
        ("bench#prove", 0, 10_000), ("bench#prove", 10_000, 20_000),
        ("rstpu.fri.layers", 1_000, 5_000), ("k", 1_500, 1_900, True), ("k", 1_800, 2_100, True),
        ("k", 4_900, 5_500, True),
        ("rstpu.fri.decommit", 6_000, 7_500), ("rstpu.decommit.plan", 6_100, 6_400),
        ("rstpu.to_host", 7_000, 7_100), ("rstpu.to_host", 7_020, 7_050),
        ("rstpu.fri.layers", 11_000, 13_000),
        ("rstpu.fri.decommit", 15_000, 17_500), ("rstpu.fri.decommit", 15_500, 16_000),
        ("rstpu.to_host", 16_000, 16_010), ("rstpu.to_host", 17_000, 17_010),
        ("aten::add", 18_000, 18_100),
    )


def _verify_trace():
    """Two calls: lowering 300 + 200 ns and 250 ns; fold host work 100 +
    50 ns and 150 ns, a walk-jobs span nested in another of its name."""
    return _trace(
        ("bench#verify_batch", 0, 5_000), ("bench#verify_batch", 5_000, 10_000),
        ("rstpu.hash.absorb_lower", 100, 400), ("rstpu.hash.walk_lower", 1_000, 1_200),
        ("rstpu.fold.prepare", 2_000, 2_100), ("rstpu.verify.walk_jobs", 2_200, 2_250),
        ("rstpu.hash.absorb_lower", 5_100, 5_350),
        ("rstpu.fold.prepare", 6_000, 6_100), ("rstpu.verify.walk_jobs", 6_200, 6_250),
        ("rstpu.verify.walk_jobs", 6_210, 6_240), ("k", 3_000, 4_000, True),
    )


def _read(metric, record):
    return registry.reader(metric)(record)


def test_idle_inside_a_span_is_its_length_less_the_kernels_in_it():
    tr = _prove_trace()
    # [1000, 5000) less the union [1500, 2100) and [4900, 5000): 3,300; [11000, 13000): 2,000
    assert program_spans.idle_s(tr, ["fri.layers"]) == pytest.approx(5_300e-9)
    assert _read("prove.fri_idle_s", {"kind": "prove", "trace": tr, "units": 2}) == pytest.approx(2_650e-9)


def test_nested_occurrences_count_once():
    tr = _prove_trace()
    assert program_spans.occurrences(tr, ["fri.decommit"]) == [[6_000, 7_500], [15_000, 17_500]]
    assert program_spans.host_s(tr, ["fri.decommit"]) == pytest.approx(4_000e-9)
    assert program_spans.count(tr, ["to_host"]) == 3
    vt = _verify_trace()
    assert program_spans.count(vt, ["verify.walk_jobs"]) == 2
    # one name inside another of the set read together counts once too
    assert program_spans.count(tr, ["fri.decommit", "decommit.plan"]) == 2


def test_metrics_divide_by_the_window_s_proofs_or_calls():
    tr, vt = _prove_trace(), _verify_trace()
    for units in (1, 2):
        prove = {"kind": "prove", "trace": tr, "units": units}
        assert _read("prove.decommit_s", prove) == pytest.approx(4_000e-9 / units)
        assert _read("prove.host_reads", prove) == pytest.approx(3 / units)
    verify = {"kind": "verify", "trace": vt, "calls": 2, "units": 2}
    assert _read("verify.lowering_ms", verify) == pytest.approx(1e3 * 750e-9 / 2)
    assert _read("verify.fold_host_ms", verify) == pytest.approx(1e3 * 300e-9 / 2)


def test_readers_read_nothing_without_their_spans():
    bare = _trace(("bench#prove", 0, 1_000), ("k", 100, 200, True), ("aten::add", 300, 400),
                  ("rstpu.renamed.span", 500, 600))
    for metric in PROVE:
        assert _read(metric, {"kind": "prove", "trace": bare, "units": 1}) is None
        assert _read(metric, {"kind": "prove", "trace": None, "units": 1}) is None
        assert _read(metric, {"kind": "verify", "trace": _prove_trace(), "calls": 1, "units": 1}) is None
    for metric in VERIFY:
        assert _read(metric, {"kind": "verify", "trace": bare, "calls": 1, "units": 1}) is None
        assert _read(metric, {"kind": "prove", "trace": _verify_trace(), "units": 1}) is None
    assert program_spans.idle_s(bare, ["fri.layers"]) is None
    assert program_spans.host_s(bare, ["fri.decommit"]) is None


def test_idle_under_spans_takes_each_gap_by_its_middle():
    tr = _prove_trace()
    idle, covered = program_spans.idle_under_spans(tr, "prove")
    # the first proof's gaps [0, 1500), [2100, 4900), [5500, 10000) have their middles at 750 (no
    # span), 3500 (fri.layers), 7750 (no span: fri.decommit ends at 7500); the second proof's one
    # gap [10000, 20000) at 15000 (fri.decommit)
    assert idle == pytest.approx((1_500 + 2_800 + 4_500 + 10_000) * 1e-9)
    assert covered == pytest.approx((2_800 + 10_000) * 1e-9)
    assert program_spans.idle_under_spans(tr, "verify_batch") == (0.0, 0.0)
