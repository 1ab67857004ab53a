"""prove.decommit_s: host seconds a proof inside the program's
decommitments, its span rstpu.fri.decommit (the host index plans, the
device gathers and their copies), on the trace's own clock.  Nothing where
the traced proofs hold no such span."""

from stwo_bench.harness import program_spans


def read(record):
    trace = record["trace"]
    if record["kind"] != "prove" or trace is None:
        return None
    seconds = program_spans.host_s(trace, ["fri.decommit"])
    return None if seconds is None else seconds / record["units"]
