"""Walls, CUDA launches and device busy time of the other proof flavours.

    python recursive_stwo_tpu_torch/tools/flavour_times.py [--root DIR] [--label NAME] [--runs K]

Imports recursive_stwo_tpu_torch from DIR (default: the checkout holding this
script), so that a parent and a change can be timed in turns in one call.

Steps, each warm:
  - np_small: verify_batch_np at B=512 on a device-resident batch;
  - level14 / bitcoin: the SHA-256 flavours' device checks
    (device_checks_p31 / device_checks_np) at B=128 on a device-resident
    batch and FSOutput;
  - level14 / bitcoin composition: the batch-1 composition check of the
    SHA fast path (verify_sha256_host.composition_on), on CUDA and on the
    CPU;
  - level14 / bitcoin fast path: verify_sha256p31 / verify_sha256np whole
    (host SHA transcript and path expansion included), on CUDA and on the
    CPU.
For each: every one of K synchronize()-bounded walls and their median; for
np_small, the transcript's wall in K further runs (`transcript.replay`, or
`run_transcript_np` in a checkout without it; each bounded by
synchronize()); for the CUDA steps, the hand-written kernels' launches over
one run (ops/launches: fold_phase, the fold kernel, and transcript, the
transcript kernel, where the checkout has them), and
one further run under torch.profiler: the kernels launched,
the copies and fills, the device busy time (the kernels' summed durations,
one stream) and its share of the untraced median wall, and the wall per
kernel launch.  Prints one JSON line per step, then the card's nvidia-smi
line.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import statistics
import subprocess
import sys
import time
from functools import lru_cache

NP_BATCH = 512  # bench.py:187-188
SHA_BATCH = 128  # bench.py:248


def walls_ms(torch, fn, runs: int) -> list:
    """Milliseconds of each of `runs` calls of fn, after one warm-up, each
    bounded by synchronize() where a card is in use."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    fn()
    out = []
    for _ in range(runs):
        sync()
        t = time.perf_counter()
        fn()
        sync()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def raw_events(torch, prof) -> list:
    """(device type, name, duration in ns) of every event of a finished
    torch.profiler trace, read from the profiler's raw results: building
    its Python event tree (prof.events(), key_averages()) takes seconds for
    the verifier's 27k launches.  That reader is not a public API of
    torch; a release that moves it raises here, naming itself."""
    try:
        return [(e.device_type(), e.name(), e.duration_ns()) for e in prof.profiler.kineto_results.events()]
    except AttributeError as exc:
        raise RuntimeError(f"torch {torch.__version__}: the profiler's raw events "
                           "(prof.profiler.kineto_results.events()) cannot be read") from exc


@lru_cache(maxsize=None)
def hand_written_kernels() -> tuple:
    """The names of the __global__ functions of csrc/ (each in an anonymous
    namespace there), as a trace names them: "(anonymous namespace)::<name>"."""
    names = []
    csrc = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
    for path in sorted(glob.glob(os.path.join(csrc, "*.cu"))):
        with open(path) as f:
            names += re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", f.read())
    return tuple(f"(anonymous namespace)::{n}" for n in names)


def count_device_events(torch, prof) -> dict:
    """Kernels (and of them the hand-written ones, csrc/'s), copies and
    fills, and the kernels' summed device time (ms) of a finished
    device-only trace, from its raw events; of that time the SHA-256
    tree-level kernel's (`sha256_ms`), and the device time of the copies
    from the card to the host (`dtoh_ms`)."""
    from torch.autograd import DeviceType

    kernels = copies = own = 0
    busy_ns = sha_ns = dtoh_ns = 0
    mine = hand_written_kernels()
    for device_type, name, duration_ns in raw_events(torch, prof):
        if device_type != DeviceType.CUDA:
            continue
        if name.startswith(("Memcpy", "Memset")):
            copies += 1
            dtoh_ns += duration_ns if name.startswith("Memcpy DtoH") else 0
        else:
            kernels += 1
            own += any(k in name for k in mine)
            busy_ns += duration_ns
            sha_ns += duration_ns if "sha256_level_kernel" in name else 0
    return dict(cuda_kernels=kernels, hand_written_kernels=own, copies_and_fills=copies, busy_ms=busy_ns / 1e6,
                sha256_ms=sha_ns / 1e6, dtoh_ms=dtoh_ns / 1e6)


def device_profile(torch, fn) -> dict:
    """Kernels, copies and fills, and the kernels' summed device time (ms)
    in one call of fn under torch.profiler, tracing the device only, from
    the raw events.  A trace with no device events is taken again, up to
    three times: CUPTI now and then returns none."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counted = count_device_events(torch, prof)
        if counted["cuda_kernels"]:
            return dict(kernels=counted["cuda_kernels"], copies_and_fills=counted["copies_and_fills"],
                        busy_ms=counted["busy_ms"])
    raise RuntimeError("the profiler saw no device event in three traces")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--label", default=None, help="name printed with every line (default: the root)")
    ap.add_argument("--runs", type=int, default=9)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("flavour_times: torch.cuda.is_available() is false; this needs a GPU", file=sys.stderr)
        return 1
    from recursive_stwo_tpu_torch.core.qm31 import QM31
    from recursive_stwo_tpu_torch.models import flagship
    from recursive_stwo_tpu_torch.ops import launches as kernel_launches
    from recursive_stwo_tpu_torch.tools.verify_times import phase_walls
    from recursive_stwo_tpu_torch.verifier import transcript
    from recursive_stwo_tpu_torch.verifier import verify_sha256 as vs
    from recursive_stwo_tpu_torch.verifier.verify_sha256_host import composition_on

    dev = torch.device("cuda")
    steps = []
    step, arrays = flagship.verifier_step_np("np_small", NP_BATCH, device=dev)
    steps.append(("np_small verify_batch_np", NP_BATCH, "cuda", lambda: step(arrays)))
    for kind in ("level14", "bitcoin"):
        c_step, c_arrays, c_fs = flagship.sha_checks_step(kind, SHA_BATCH, device=dev)
        steps.append((f"{kind} device checks", SHA_BATCH, "cuda",
                      lambda s=c_step, a=c_arrays, f=c_fs: s(a, f)))
        spec, pa, fs = flagship.sha_prepared(kind)
        sums = [pa.plonk_total_sum] + ([pa.poseidon_total_sum] if kind == "level14" else [])
        sums = [QM31(*(s[:, i] for i in range(4))) for s in sums]
        proof = flagship.sha_artifact(kind)
        fast = vs.verify_sha256p31 if kind == "level14" else vs.verify_sha256np
        inputs = flagship.sha_inputs(kind)
        for device in ("cuda", "cpu"):
            steps.append((f"{kind} fast-path composition", 1, device,
                          lambda spec=spec, pa=pa, sums=sums, fs=fs, d=device:
                          composition_on(spec, pa.samples_flat, sums, fs, d)))
            steps.append((f"{kind} fast path", 1, device,
                          lambda fast=fast, p=proof, i=inputs, d=device: fast(p, i, device=d)))

    for name, batch, device, fn in steps:
        walls = walls_ms(torch, fn, args.runs)
        med = statistics.median(walls)
        line = dict(label=args.label or args.root, step=name, batch=batch, device=device, wall_ms_median=med,
                    wall_ms=walls, proofs_per_s=batch / med * 1e3)
        if name.startswith("np_small"):
            replay = "replay" if hasattr(transcript, "replay") else "run_transcript_np"
            t = phase_walls(torch, lambda _: fn(), None, args.runs, transcript, replay)
            line.update(transcript_ms_median=statistics.median(t) * 1e3, transcript_ms=[x * 1e3 for x in t])
        if device == "cuda":
            torch.cuda.synchronize()
            kernel_launches.reset()
            fn()
            torch.cuda.synchronize()
            line["launches"] = kernel_launches.counts()
            prof = device_profile(torch, fn)
            line.update(prof, busy_share=prof["busy_ms"] / med, wall_us_per_kernel=med * 1e3 / prof["kernels"])
        print(json.dumps(line), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
