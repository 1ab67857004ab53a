"""Time and peak device memory of the port's prover, per stage, on CUDA.

    python -m recursive_stwo_tpu_torch.tools.prover_memory LOG_PLONK LOG_POSEIDON PRESET
    python -m recursive_stwo_tpu_torch.tools.prover_memory --level {1,2,3}
        [--repeat K] [--profile]

The first form builds a circuit of chained Poseidon2 permutations and QM31
products whose plonk and poseidon tables pad to 2**LOG_PLONK and
2**LOG_POSEIDON rows (the chain's log sizes are in docs/chain_log.jsonl),
proves it with the preset's PcsConfig (models/flagship.PRESETS) and checks
the proof with the port's verifier.  The second proves a recursion-chain
level whose input the repo holds, 1, 2 or 3 (models/flagship.chain_level_trace),
and holds its m31x8 bytes to the sha256 docs/chain_artifacts.txt lists
(tools/chain.py proves the later levels).

Each of the K proofs prints one JSON line: its wall time, and the time and
peak of `torch.cuda.max_memory_allocated()` in each prover stage.  The first
proof in the process is cold (host tables built per log size); the later
ones are warm.  The first-layer quotients are the stage that ends with "FRI
first-layer quotients computed"; the transforms run inside the tree stages.
`--profile` adds one more proof under `torch.profiler` and prints its device
time: all kernels, K1 (`permute_rows`), the circle FFT's passes and tile
twiddles (`fft_`), the quotient kernels (`quotient_`), the sampling kernels
(`sample_`), the interaction kernel (`interaction_kernel`), the fold-layer
and Merkle level kernels (`fri_layer_kernel`, `merkle_level_kernel`), the `% p`
(`remainder`) kernels, copies, and the launch counts, the hand-written
kernels' (csrc/) apart from eager torch's; and `by_stage`, the same proof's
CUDA kernels by prover stage, hand-written and eager apart, with their
device time.  A stage is what runs between two `progress` messages (named
by the message that ends it); each runs inside a `record_function` range,
and a kernel belongs to the range its start on the card falls in (the
trace puts the card's times on the host's clock): a kernel starts after its
stage's range opens, and the range closes after a synchronize(), so no
kernel runs past its stage.  It needs a GPU; an out-of-memory error
ends it with that error.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import time

import torch
from torch.profiler import record_function

from ..cs.system import PlonkWithPoseidonCS
from ..gadgets.fields import QM31Var
from ..gadgets.poseidon import Poseidon2Half
from ..models import flagship
from ..prover.air import ROWS_PER_INV
from ..prover.prove import prove
from .chain import timed_proof
from .flavour_times import hand_written_kernels
from ..verifier import hints, verify
from ..verifier.arrays import to_torch
from ..verifier.spec import VerifierSpec

# chain levels whose input is a fixture or a committed artifact
COMMITTED_INPUT_LEVELS = (1, 2, 3)


def shaped_trace(log_plonk: int, log_poseidon: int) -> dict:
    """A valid trace whose tables pad to the given log sizes: each Poseidon2
    permutation takes 6 poseidon rows and 1 plonk row, each QM31 product 1
    plonk row."""
    n_perms = (1 << (log_poseidon - 1)) // ROWS_PER_INV + 1
    if log_plonk <= (n_perms + 64).bit_length():
        raise ValueError(f"log_plonk {log_plonk} is too small for {n_perms} permutations")
    cs = PlonkWithPoseidonCS()
    left = Poseidon2Half.new_witness(cs, list(range(8)))
    right = Poseidon2Half.new_witness(cs, list(range(8, 16)))
    for _ in range(n_perms):
        left = Poseidon2Half.permute_get_rate(left, right)
    x = QM31Var.new_witness(cs, (1, 2, 3, 4))
    while len(cs.a_wire) <= 1 << (log_plonk - 1):
        x = x * x
    cs.pad()
    cs.check_arithmetics()
    cs.populate_logup_arguments()
    cs.check_poseidon_invocations()
    return cs.generate_trace()


def _device_time(prof) -> dict:
    """Device time of one profiled proof, from the CUDA-side events only (a
    CPU op's own device total would count its kernels a second time)."""
    from torch.autograd import DeviceType

    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and not e.key.startswith(STAGE)]

    def ms(es) -> float:
        return round(sum(e.self_device_time_total for e in es) / 1e3, 3)

    copies = [e for e in events if e.key.startswith(("Memcpy", "Memset"))]
    kernels = [e for e in events if e not in copies]
    k1 = [e for e in kernels if "permute_rows" in e.key]
    fft = [e for e in kernels if "fft_" in e.key]
    quot = [e for e in kernels if "quotient_" in e.key]
    smp = [e for e in kernels if "sample_" in e.key]
    inter = [e for e in kernels if "interaction_kernel" in e.key]
    fold = [e for e in kernels if "fri_layer_kernel" in e.key]
    merkle = [e for e in kernels if "merkle_level_kernel" in e.key]
    own = [e for e in kernels if any(k in e.key for k in hand_written_kernels())]
    rem = [e for e in kernels if "remainder" in e.key.lower()]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return dict(
        kernel_ms=ms(kernels), kernel_launches=sum(e.count for e in kernels),
        hand_written_launches=sum(e.count for e in own), eager_launches=sum(e.count for e in kernels if e not in own),
        k1_ms=ms(k1), k1_launches=sum(e.count for e in k1),
        fft_ms=ms(fft), fft_launches=sum(e.count for e in fft), quotients_ms=ms(quot),
        quotient_launches=sum(e.count for e in quot), sample_ms=ms(smp), sample_launches=sum(e.count for e in smp),
        interaction_ms=ms(inter), interaction_launches=sum(e.count for e in inter),
        fri_fold_ms=ms(fold), fri_fold_launches=sum(e.count for e in fold),
        merkle_ms=ms(merkle), merkle_launches=sum(e.count for e in merkle),
        remainder_ms=ms(rem), remainder_launches=sum(e.count for e in rem),
        copy_ms=ms(copies), copies=sum(e.count for e in copies),
        top=[dict(kernel=e.key[:100], ms=ms([e]), launches=e.count) for e in top],
    )


STAGE = "stage#"  # the record_function ranges of a staged proof


class StageRanges:
    """`progress` for a proof under torch.profiler: each stage runs inside
    its own record_function range, STAGE + its index; `messages[i]` names
    stage i (the message that ended it; the last, after the last message,
    is the proof's tail)."""

    def __init__(self):
        self.messages = []
        self._range = None

    def start(self) -> None:
        self._range = record_function(f"{STAGE}{len(self.messages)}")
        self._range.__enter__()

    def __call__(self, msg: str) -> None:
        torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self.messages.append(msg)
        self.start()

    def finish(self) -> None:
        torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self.messages.append("after the last stage message")


def by_stage(events, messages: list) -> list:
    """The CUDA kernels of a staged proof's trace by stage (see the module
    docstring), from the trace's raw events (prof.profiler.kineto_results
    .events()) and the stages' messages: [{stage, kernels, hand_written,
    eager, busy_ms}]."""
    from torch.autograd import DeviceType

    spans = sorted((e.start_ns(), e.end_ns(), int(e.name()[len(STAGE):])) for e in events
                   if e.device_type() == DeviceType.CPU and e.name().startswith(STAGE))
    mine = hand_written_kernels()
    out = [dict(stage=m, kernels=0, hand_written=0, eager=0, busy_ms=0.0) for m in messages]
    unplaced = 0
    for e in events:
        name = e.name()
        if e.device_type() != DeviceType.CUDA or name.startswith((STAGE, "Memcpy", "Memset")):
            continue
        t = e.start_ns()
        k = next((i for s, end, i in spans if s <= t < end), None)
        if k is None:
            unplaced += 1
            continue
        row = out[k]
        row["kernels"] += 1
        own = any(m in name for m in mine)
        row["hand_written"] += own
        row["eager"] += not own
        row["busy_ms"] += e.duration_ns() / 1e6
    for row in out:
        row["busy_ms"] = round(row["busy_ms"], 3)
    if unplaced:
        out.append(dict(stage="outside every stage", kernels=unplaced))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("shape", nargs="*", metavar="LOG_PLONK LOG_POSEIDON PRESET")
    ap.add_argument("--level", type=int, choices=COMMITTED_INPUT_LEVELS)
    ap.add_argument("--repeat", type=int, default=1, help="proofs in this process (the first is cold)")
    ap.add_argument("--profile", action="store_true", help="one more proof under torch.profiler")
    args = ap.parse_args()
    if (args.level is None) == (len(args.shape) == 0) or len(args.shape) not in (0, 3):
        ap.error("give LOG_PLONK LOG_POSEIDON PRESET, or --level")
    if args.shape and args.shape[2] not in flagship.PRESETS:
        ap.error(f"PRESET is one of {sorted(flagship.PRESETS)}")
    if not torch.cuda.is_available():
        raise SystemExit("prover_memory needs a CUDA device")

    if args.level is None:
        config = flagship.PRESETS[args.shape[2]]
        trace = shaped_trace(int(args.shape[0]), int(args.shape[1]))
        expected, label = None, dict(preset=args.shape[2])
    else:
        trace, config, path = flagship.chain_level_trace(args.level)
        name = os.path.basename(path)[: -len(".pkl")]
        expected, label = flagship.expected_sha256(name), dict(level=args.level)

    def check(proof) -> None:
        if expected is not None:
            if hashlib.sha256(flagship.proof_bytes(proof)).hexdigest() != expected:
                raise SystemExit(f"level {args.level}: the proof bytes do not hash to {name}.bin's {expected}")
            return
        spec = VerifierSpec.from_proof(proof)
        checks = verify.verify_batch(spec, to_torch(hints.prepare(spec, [proof]), "cuda"), flagship.CHAIN_INPUTS)
        if not bool(checks["ok"].all()):
            raise SystemExit(f"the proof was rejected: {[k for k, v in checks.items() if not bool(v.all())]}")

    device = dict(name=torch.cuda.get_device_name(0))
    for run in range(args.repeat):
        proof, timing = timed_proof(lambda progress: prove(trace, config, progress=progress, device="cuda"), "cuda")
        check(proof)
        spec = VerifierSpec.from_proof(proof)
        print(json.dumps(dict(
            **label, run=run, cold=run == 0, log_plonk=proof.log_size_plonk, log_poseidon=proof.log_size_poseidon,
            max_domain_log=max(spec.all_log_sizes), correct=True, wall_s=timing["prove_s"],
            peak_bytes=timing["peak_bytes"], device=device, stages=timing["stages"],
        )), flush=True)

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        stages = StageRanges()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            stages.start()
            proof = prove(trace, config, progress=stages, device="cuda")
            stages.finish()
            traced = time.perf_counter() - start
        check(proof)
        print(json.dumps(dict(**label, profiled=True, traced_wall_s=round(traced, 4), device=device,
                              **_device_time(prof),
                              by_stage=by_stage(prof.profiler.kineto_results.events(), stages.messages))), flush=True)


if __name__ == "__main__":
    main()
