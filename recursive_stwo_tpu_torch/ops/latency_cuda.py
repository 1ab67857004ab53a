"""ctypes wrapper of the latency probe (csrc/latency.cu).

  step_latencies(device) -> {kind: cycles}, plus "ghz"
      the cycles one dependent operation of each kind takes on the card (a
      chain of STEPS on one warp, between two clock64 reads), and the SM
      clock the chain ran at (its cycles over its CUDA-event time).

The latency floors of the transcript kernel and the composition check kernel
(ops/transcript_cuda.py and ops/composition_cuda.py `latency_floor_ms`) are
their chains' dependent steps times these.  The probe is on no verifier or
prover path; `LAUNCHES` counts its launches.  It needs a CUDA device.
"""

from __future__ import annotations

import torch

from . import build
from .poseidon_cuda import _raise_on

P = 2**31 - 1
LAUNCHES = {"latency_probe": 0}
# csrc/latency.cu's kinds: m31.cuh's add, mul, mul_pow2 and a xor-shuffle
KINDS = ("add", "mul", "rot", "shfl")
STEPS = 1 << 20


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def probe(kind: str, device, steps: int = STEPS) -> tuple:
    """(cycles, milliseconds) of one chain of `steps` operations of `kind`."""
    gen = torch.Generator(device=device).manual_seed(len(KINDS) + KINDS.index(kind))
    seed = torch.randint(1, P, (64,), generator=gen, device=device, dtype=torch.int64)
    out = torch.empty(33, dtype=torch.int64, device=device)
    lib = build.load()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        start.record()
        err = lib.latency_probe(KINDS.index(kind), steps, seed.data_ptr(), out.data_ptr(), stream)
        end.record()
    _raise_on(err, "latency_probe")
    LAUNCHES["latency_probe"] += 1
    torch.cuda.synchronize(device)
    return int(out[32]), start.elapsed_time(end)


def step_latencies(device) -> dict:
    """Cycles a dependent step of each kind (a warm-up chain first), and
    "ghz", the SM clock over the chains."""
    probe("add", device, 16 * 1024)
    got, cycles, ms = {}, 0, 0.0
    for kind in KINDS:
        c, t = probe(kind, device)
        got[kind] = c / STEPS
        cycles, ms = cycles + c, ms + t
    got["ghz"] = cycles / ms / 1e6
    return got
