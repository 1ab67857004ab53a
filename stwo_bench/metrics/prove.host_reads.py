"""prove.host_reads: reads from the card to the host a proof, the program's
rstpu.to_host spans (one at each such read) in the traced proofs.  Nothing
where they hold no such span."""

from stwo_bench.harness import program_spans


def read(record):
    trace = record["trace"]
    if record["kind"] != "prove" or trace is None:
        return None
    reads = program_spans.count(trace, ["to_host"])
    return None if reads is None else reads / record["units"]
