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

import pytest
from test_torch_stream import STREAM, T_CONFIG, _np_trace

from recursive_stwo_tpu_torch.models import flagship
from recursive_stwo_tpu_torch.prover.prove import prove
from recursive_stwo_tpu_torch.prover.prove_np import prove_np
from recursive_stwo_tpu_torch.prover.stream import prove_np_streamed, prove_streamed
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
