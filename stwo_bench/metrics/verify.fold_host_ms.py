"""verify.fold_host_ms: host milliseconds a verifier call around the fold
kernel, the program's spans rstpu.fold.prepare (the wrapper's work before
its launch) and rstpu.verify.walk_jobs (the FRI pair walks assembled), on
the trace's own clock.  Nothing where the traced calls hold neither span."""

from stwo_bench.harness import program_spans


def read(record):
    trace = record["trace"]
    if record["kind"] != "verify" or trace is None:
        return None
    seconds = program_spans.host_s(trace, ["fold.prepare", "verify.walk_jobs"])
    return None if seconds is None else 1e3 * seconds / record["calls"]
