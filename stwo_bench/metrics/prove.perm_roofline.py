"""prove.perm_roofline: the least time of the traced proofs' Merkle
permutations (every node of the four trees and of each FRI layer's tree,
counted from the configuration's shapes, harness/work.py) at the SM issue
ceiling, over the device time of all their kernels, in percent."""

from stwo_bench.harness import work


def read(record):
    trace = record["trace"]
    if record["kind"] != "prove" or trace is None or trace.kernel_s <= 0:
        return None
    return 100.0 * work.perm_seconds(record["work"]["perms_per_proof"] * record["units"]) / trace.kernel_s
