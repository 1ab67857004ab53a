"""verify_p95_ms: the 95th percentile (nearest rank) of every call's
latency in the window, from the hand-over of its batch to its verdicts on
the host."""

from stwo_bench.harness.stats import p95


def read(record):
    if record["kind"] != "verify":
        return None
    return p95(record["latencies_s"]) * 1e3
