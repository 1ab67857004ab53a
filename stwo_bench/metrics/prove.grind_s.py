"""prove.grind_s: host seconds a proof inside the program's proof-of-work
grind, its span rstpu.fri.grind (in the Sha256MerkleChannel flavour the
channel's native host scan), on the trace's own clock.  Nothing where the
traced proofs hold no such span."""

from stwo_bench.harness import program_spans


def read(record):
    trace = record["trace"]
    if record["kind"] != "prove" or trace is None:
        return None
    seconds = program_spans.host_s(trace, ["fri.grind"])
    return None if seconds is None else seconds / record["units"]
