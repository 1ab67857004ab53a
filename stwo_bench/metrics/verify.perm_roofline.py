"""verify.perm_roofline: the least time of the window's verifier work, the
larger of its Poseidon2 permutations at the SM issue ceiling and of reading
its prepared arrays once at the HBM bandwidth (harness/work.py), over the
device time of all the window's kernels, in percent."""

from stwo_bench.harness import work


def read(record):
    trace = record["trace"]
    if record["kind"] != "verify" or trace is None or trace.kernel_s <= 0:
        return None
    w = record["work"]
    least = max(work.perm_seconds(w["perms_per_proof"] * record["proofs"]),
                w["words_per_proof"] * work.M31_BYTES * record["proofs"] / work.H100_BYTES_PER_S)
    return 100.0 * least / trace.kernel_s
