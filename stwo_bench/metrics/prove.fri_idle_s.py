"""prove.fri_idle_s: seconds a proof in which the card idles inside the
program's FRI commit stage, its span rstpu.fri.layers (the first-layer
tree, each layer's fold, tree, root mixed and alpha drawn, the last layer
on the host), on the trace's own clock.  Nothing where the traced proofs
hold no such span."""

from stwo_bench.harness import program_spans


def read(record):
    trace = record["trace"]
    if record["kind"] != "prove" or trace is None:
        return None
    idle = program_spans.idle_s(trace, ["fri.layers"])
    return None if idle is None else idle / record["units"]
