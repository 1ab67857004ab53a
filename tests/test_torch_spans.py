"""The port's spans (recursive_stwo_tpu_torch/utils/spans.py) on the CPU,
under torch.profiler with CPU activity: a proof of the demo circuit,
resident and streamed, and a verify_batch of the small fixture record the
spans of the contract, nested as it lists them, as function-scope ranges
(never a `record_function` range's scope); proof bytes and verdicts are the
same with and without the profiler, and two profiled runs of one proof
count the same reads to the host."""

from functools import lru_cache

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from recursive_stwo_tpu_torch.models import flagship
from recursive_stwo_tpu_torch.proof.containers import FriConfig, PcsConfig
from recursive_stwo_tpu_torch.prover.prove import prove
from recursive_stwo_tpu_torch.prover.stream import prove_streamed
from recursive_stwo_tpu_torch.utils.spans import PREFIX, span
from recursive_stwo_tpu_torch.verifier import verify
from recursive_stwo_tpu_torch.verifier.arrays import to_torch

CONFIG = PcsConfig(pow_bits=5, fri_config=FriConfig(1, 3, 9))
PROBE = "probe of a record_function range"

# child: the spans every occurrence of it lies inside (one of them)
PROVER_NESTING = {
    "prove.air": (),
    "prove.upload": (),
    "fri.layers": (),
    "fri.first_tree": ("fri.layers",),
    "fri.fold": ("fri.layers",),
    "fri.layer_tree": ("fri.layers",),
    "channel.mix_root": ("fri.layers",),
    "channel.draw": ("fri.layers",),
    "fri.last_layer": ("fri.layers",),
    "fri.grind": (),
    "fri.queries": (),
    "fri.decommit": (),
    "decommit.plan": ("fri.decommit",),
    "decommit.gather": ("fri.decommit",),
    "tree.commit": (),
    "to_host": (),
}
STREAMED_NESTING = {
    "stream.chunk": ("tree.commit",),
    "stream.host_levels": ("tree.commit",),
    "stream.recompute": ("decommit.gather",),
}
VERIFIER_NESTING = {
    "verify.transcript": (),
    "verify.composition": (),
    "verify.fold": (),
    "verify.walk_jobs": ("verify.fold",),
    "verify.hash": (),
    "hash.absorb_lower": ("verify.hash",),
    "hash.leaf": ("verify.hash",),
    "hash.walk_lower": ("verify.hash",),
    "hash.scan": ("verify.hash",),
}


def _profiled(fn):
    """(fn's result, [(name, start_ns, end_ns, scope)] of every event), a
    record_function range named PROBE recorded first."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(PROBE):
            pass
        out = fn()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.scope())
              for e in prof.profiler.kineto_results.events()]
    return out, events


def _spans(events) -> dict:
    """{name without PREFIX: [(start, end), ...]} of the port's spans."""
    out = {}
    for name, s, e, _ in events:
        if name.startswith(PREFIX):
            out.setdefault(name[len(PREFIX):], []).append((s, e))
    return out


def _assert_nesting(spans: dict, nesting: dict) -> None:
    for child, parents in nesting.items():
        assert spans.get(child), f"no {child} span"
        if not parents:
            continue
        outer = [iv for p in parents for iv in spans.get(p, [])]
        for s, e in spans[child]:
            assert any(ps <= s and e <= pe for ps, pe in outer), f"a {child} span outside {parents}"


@lru_cache(maxsize=None)
def _trace():
    return flagship.demo_trace()


@lru_cache(maxsize=None)
def _plain_proof() -> bytes:
    return flagship.proof_bytes(prove(_trace(), CONFIG, device="cpu"))


@lru_cache(maxsize=None)
def _profiled_proof():
    proof, events = _profiled(lambda: prove(_trace(), CONFIG, device="cpu"))
    return flagship.proof_bytes(proof), events


def test_proof_records_the_prover_spans_nested():
    _, events = _profiled_proof()
    spans = _spans(events)
    _assert_nesting(spans, PROVER_NESTING)
    # the trees of the FRI layers are built inside their spans, the last
    # layer's evaluations read back inside fri.last_layer
    first, layer = spans["fri.first_tree"], spans["fri.layer_tree"]
    commits = spans["tree.commit"]
    for s, e in first + layer:
        assert any(s <= cs and ce <= e for cs, ce in commits), "a FRI tree without its tree.commit"
    assert len(commits) == 4 + len(first) + len(layer)
    assert len(spans["fri.fold"]) == len(layer) + 1
    assert len(spans["channel.mix_root"]) == len(spans["channel.draw"]) == len(layer) + 1
    for s, e in spans["fri.last_layer"]:
        assert any(s <= hs and he <= e for hs, he in spans["to_host"])
    assert len(spans["fri.layers"]) == len(spans["fri.decommit"]) == 1


def test_streamed_proof_records_the_streamed_tree_spans():
    proof, events = _profiled(lambda: prove_streamed(_trace(), CONFIG, device="cpu", chunk_log=9, cutoff=5))
    assert flagship.proof_bytes(proof) == _plain_proof()
    spans = _spans(events)
    _assert_nesting(spans, {**PROVER_NESTING, **STREAMED_NESTING})
    # the four trees stream; the FRI layers' trees, below 2**23, are resident
    assert len(spans["stream.host_levels"]) == 4


def test_verify_batch_records_the_verifier_spans_nested():
    spec, pa1 = flagship.prepared_arrays("small_proof")
    pa = to_torch(flagship.tiled_batch(pa1, 2), "cpu")
    inputs = flagship.FIXTURE_INPUTS["small_proof"]
    plain = verify.verify_batch(spec, pa, inputs)
    traced, events = _profiled(lambda: verify.verify_batch(spec, pa, inputs))
    assert list(plain) == list(traced)
    for k in plain:
        assert torch.equal(plain[k], traced[k]), k
    assert bool(traced["ok"].all())
    spans = _spans(events)
    _assert_nesting(spans, VERIFIER_NESTING)
    assert len(spans["hash.scan"]) == 2 and len(spans["verify.hash"]) == 1
    # the fold kernel's host work is CUDA's alone: the CPU takes the plain version
    assert "fold.prepare" not in spans


def test_spans_are_function_scope_ranges():
    """Every rstpu. event has a scope other than the record_function probe's
    (user scope, which the profiler copies onto the card's timeline)."""
    _, events = _profiled_proof()
    probe = {scope for name, _, _, scope in events if name == PROBE}
    assert len(probe) == 1
    scopes = {scope for name, _, _, scope in events if name.startswith(PREFIX)}
    assert scopes and not scopes & probe, (scopes, probe)


def test_proof_bytes_equal_with_and_without_the_profiler():
    assert _profiled_proof()[0] == _plain_proof()


def test_host_reads_counted_alike_in_two_profiled_runs():
    first = len(_spans(_profiled_proof()[1])["to_host"])
    proof, events = _profiled(lambda: prove(_trace(), CONFIG, device="cpu"))
    assert flagship.proof_bytes(proof) == _plain_proof()
    assert len(_spans(events)["to_host"]) == first > 0


@pytest.mark.parametrize("name", ["to_host", "fri.layers"])
def test_span_without_a_profiler_records_nothing(name):
    """Outside a profiler a span is entered and left and leaves no event
    behind for a profiler started later; nesting one in itself is allowed."""
    with span(name):
        with span(name):
            x = torch.ones(4).sum()
    _, events = _profiled(lambda: None)
    assert float(x) == 4.0
    assert not _spans(events)
