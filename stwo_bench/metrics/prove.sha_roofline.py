"""prove.sha_roofline: the least time of the traced proofs' SHA-256
compressions on the card (every leaf and node of the four trees and of each
FRI layer's tree down to the streamed trees' cutoff, counted from the
configuration's shapes, harness/work_sha.py) at the SM issue ceiling, over
the device time of the SHA-256 tree-level kernel alone (csrc/sha256.cu
`sha256_level_kernel`, whose name the trace's kernel names contain), in
percent.  Nothing where the traced window ran no such kernel."""

from stwo_bench.harness import work_sha

KERNEL = "sha256_level_kernel"


def read(record):
    trace = record["trace"]
    if record["kind"] != "prove" or trace is None or "sha_compressions_per_proof" not in record["work"]:
        return None
    kernel_s = sum(e - s for name, s, e in trace.kernels if KERNEL in name) / 1e9
    if kernel_s <= 0:
        return None
    least = work_sha.compression_seconds(record["work"]["sha_compressions_per_proof"] * record["units"])
    return 100.0 * least / kernel_s
