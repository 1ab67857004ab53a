"""Wall times of the verifier's main path on CUDA, for one checkout or another.

    python recursive_stwo_tpu_torch/tools/verify_times.py [--root DIR] [--label NAME] [--runs K]

Imports recursive_stwo_tpu_torch from DIR (default: the checkout holding this
script), so that a parent and a change can be timed in turns in one call on
one card.  For each fixture at B=1024, on a device-resident batch, warm:
  - the hand-written kernels' launches over one verify_batch (ops/launches;
    fold_phase, the fold kernel, and transcript, the transcript kernel,
    where the checkout has them);
  - proofs/s: B over the median of K synchronize()-bounded verify_batch runs;
  - the walls of the transcript (`transcript.replay`, or `run_transcript`
    in a checkout without it), the composition check, the fold phase and
    the hash phase: the median over K further runs of each, bounded by
    synchronize() on both sides (separate runs, since those syncs cut the
    host's run-ahead);
  - one verify_batch under torch.profiler: the device time of the hash
    kernels (every kernel whose name holds "wordmajor": K2's steps, or the
    scans and K2's leaf step), of the fold kernel and of the transcript
    kernel, the device time of each kernel name in that trace (the ten
    largest) and their sum, and from another traced call every CUDA
    kernel, copy and fill the call issued with the kernels' summed device
    time (tools/flavour_times).
Prints one JSON line per fixture, then the card's nvidia-smi line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

BATCH = 1024
FIXTURES = ("small_proof", "recursive_proof_16_15")


def phase_walls(torch, step, arrays, runs: int, owner, name: str) -> list:
    """Seconds of owner.name (a function step calls through its module) in
    each of `runs` calls of step(arrays), bounded by synchronize() on both
    sides."""
    walls = []
    phase = getattr(owner, name)

    def timed(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = phase(*a)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        return out

    setattr(owner, name, timed)
    try:
        for _ in range(runs):
            step(arrays)
    finally:
        setattr(owner, name, phase)
    return walls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--label", default=None, help="name printed with every line (default: the root)")
    ap.add_argument("--runs", type=int, default=9)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("verify_times: torch.cuda.is_available() is false; this needs a GPU", file=sys.stderr)
        return 1
    from recursive_stwo_tpu_torch.models import flagship
    from recursive_stwo_tpu_torch.ops import launches as kernel_launches
    from recursive_stwo_tpu_torch.tools.flavour_times import device_profile
    from recursive_stwo_tpu_torch.verifier import composition, transcript, verify

    dev = torch.device("cuda")
    for name in FIXTURES:
        step, arrays = flagship.verifier_step(name, BATCH, device=dev)
        if not bool(step(arrays)["ok"].all()):
            raise RuntimeError(f"{name}: clean batch rejected")
        torch.cuda.synchronize()
        kernel_launches.reset()
        step(arrays)
        torch.cuda.synchronize()
        launches = kernel_launches.counts()

        walls = []
        for _ in range(args.runs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            step(arrays)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)

        replay = "replay" if hasattr(transcript, "replay") else "run_transcript"
        phases = {phase: phase_walls(torch, step, arrays, args.runs, owner, attr)
                  for phase, owner, attr in (("transcript", transcript, replay),
                                            ("composition", composition, "composition_check"),
                                            ("fold_phase", verify, "fold_phase"),
                                            ("hash_phase", verify, "hash_phase"))}
        issued = device_profile(torch, lambda: step(arrays))

        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(arrays)
            torch.cuda.synchronize()

        def total(e):
            return getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0)) / 1e3

        by_name = {e.key: total(e) for e in prof.key_averages() if total(e) > 0}

        def device_ms(part):
            return sum(ms for key, ms in by_name.items() if part in key)

        print(json.dumps(dict(
            label=args.label or args.root, fixture=name, batch=BATCH, launches=launches,
            proofs_per_s=BATCH / statistics.median(walls),
            verify_ms=[w * 1e3 for w in walls],
            **{f"{phase}_ms_median": statistics.median(w) * 1e3 for phase, w in phases.items()},
            **{f"{phase}_ms": [x * 1e3 for x in w] for phase, w in phases.items()},
            hash_kernel_device_ms=device_ms("wordmajor"), fold_kernel_device_ms=device_ms("fold_kernel"),
            transcript_kernel_device_ms=device_ms("transcript_"),
            device_ms_by_name=dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:10]),
            traced_device_ms=sum(by_name.values()),
            cuda_kernels=issued["kernels"], copies_and_fills=issued["copies_and_fills"],
            kernels_busy_ms=issued["busy_ms"], busy_share=issued["busy_ms"] / statistics.median(walls) / 1e3,
        )), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
