"""The stage sequence of the port's provers (recursive_stwo_tpu_torch/prover/
flow.py) on the CPU: each of the four entry points, in the Poseidon31
flavour on the small traces of the byte-exact tests, announces the same
stages in the same order through its `progress` callback.

The benchmark times a traced proof's stages by these messages
(`stwo_bench/metrics/prove.commit_s.py` reads the "tree... committed"
stages, `prove.fri_s.py` the span from "FRI first-layer quotients computed"
to "FRI layers committed"), so a stage renamed, dropped or moved in one
entry point fails here.

    python -m pytest tests/test_torch_flow.py -q
"""

import hashlib

import pytest
from test_torch_stream import STREAM, T_CONFIG, _np_trace
from torch.profiler import ProfilerActivity, profile

from recursive_stwo_tpu_torch.models import flagship
from recursive_stwo_tpu_torch.prover.prove import prove
from recursive_stwo_tpu_torch.prover.prove_np import prove_np
from recursive_stwo_tpu_torch.prover.stream import prove_np_streamed, prove_streamed
from recursive_stwo_tpu_torch.utils.spans import PREFIX
from recursive_stwo_tpu_torch.verifier.spec import NoPoseidonVerifierSpec, VerifierSpec

# entry point: (prover, the circuit's trace, streamed)
PROVERS = {
    "prove": (prove, flagship.demo_trace, False),
    "prove_np": (prove_np, _np_trace, False),
    "prove_streamed": (prove_streamed, flagship.demo_trace, True),
    "prove_np_streamed": (prove_np_streamed, _np_trace, True),
}


@pytest.mark.parametrize("entry", list(PROVERS))
def test_entry_points_announce_the_flow_stages(entry):
    fn, trace, streamed = PROVERS[entry]
    stages = []
    proof = fn(trace(), T_CONFIG, progress=stages.append, device="cpu", **(STREAM if streamed else {}))
    if hasattr(proof, "log_size"):
        logs = [proof.log_size]
        spec = NoPoseidonVerifierSpec.for_rows(proof.log_size, T_CONFIG)
    else:
        logs = [proof.log_size_plonk, proof.log_size_poseidon]
        spec = VerifierSpec.from_proof(proof)
    sizes = "/".join(map(str, logs))
    want = [
        f"trace uploaded (log sizes {sizes}, composition bound {spec.composition_log_degree_bound})",
        "tree0 (preprocessed) committed",
        "tree1 (trace) committed",
        "interaction columns generated",
        "tree2 (interaction) committed",
        "composition coefficients computed",
        "tree3 (composition) committed",
        "OODS samples computed",
    ]
    if streamed:
        want += [f"quotients at log {L} streamed" for L in spec.all_log_sizes]
    want += [
        "FRI first-layer quotients computed",
        "FRI layers committed; grinding PoW",
        "PoW ground",
        "decommitments gathered",
    ]
    assert stages == want


# each entry point's proof bytes (sha256) on these traces, as the flow gave
# them before it opened the interaction and composition spans
PINNED = {
    "prove": "b68840174dca51d40743a0f0404d82160cda184b4b346e57a4ed463c48f560a6",
    "prove_np": "2ae1fba2e613a14a1d1f50044681a82c0a807455fec1eb16f30335e2c4c9391d",
    "prove_streamed": "b68840174dca51d40743a0f0404d82160cda184b4b346e57a4ed463c48f560a6",
    "prove_np_streamed": "2ae1fba2e613a14a1d1f50044681a82c0a807455fec1eb16f30335e2c4c9391d",
}


@pytest.mark.parametrize("entry", list(PROVERS))
def test_traced_proof_opens_the_interaction_and_composition_spans(entry):
    """Under the profiler each entry point opens `prove.interaction` and
    then `prove.composition` once a proof, apart, each inside the stage its
    progress message ends (the interaction columns before "interaction
    columns generated", the composition before "composition coefficients
    computed"), and the proof's bytes are the pinned ones."""
    fn, trace, streamed = PROVERS[entry]
    trace = trace()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        proof = fn(trace, T_CONFIG, device="cpu", **(STREAM if streamed else {}))
    spans = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(PREFIX):
            spans.setdefault(e.name()[len(PREFIX):], []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    inter, comp = spans.get("prove.interaction", []), spans.get("prove.composition", [])
    assert len(inter) == len(comp) == 1
    assert inter[0][1] <= comp[0][0]
    # the trees between them: tree 2's commit lies after the interaction span, before the composition's
    commits = sorted(spans["tree.commit"])
    assert [c for c in commits if inter[0][1] <= c[0] and c[1] <= comp[0][0]] == [commits[2]]
    assert hashlib.sha256(flagship.proof_bytes(proof)).hexdigest() == PINNED[entry]
