"""verify.lowering_ms: host milliseconds a verifier call lowering the hash
phase's two passes to op tables, the program's spans rstpu.hash.absorb_lower
and rstpu.hash.walk_lower, on the trace's own clock.  Nothing where the
traced calls hold neither span."""

from stwo_bench.harness import program_spans


def read(record):
    trace = record["trace"]
    if record["kind"] != "verify" or trace is None:
        return None
    seconds = program_spans.host_s(trace, ["hash.absorb_lower", "hash.walk_lower"])
    return None if seconds is None else 1e3 * seconds / record["calls"]
