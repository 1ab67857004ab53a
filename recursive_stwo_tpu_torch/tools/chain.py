"""The recursion chain re-proved on CUDA by the port, from level 3 to the
bitcoin-facing last layer, each proof held to docs/chain_artifacts.txt.

    python -m recursive_stwo_tpu_torch.tools.chain [--from N] [--to N] [--out DIR] [--streamed]

Twin of examples/recursion_chain.py (`demo_recurse`, `main`) and
examples/last_layer.py (`main`).  Level N (3-14) verifies level N-1's proof
in one circuit (`flagship.chain_level_trace`) and proves it on CUDA: levels
3-13 with the Poseidon31 channel (`prove`), level 14 in the
Sha256Poseidon31 flavour (`prove_sha256p31`).  Level 15 is the last layer:
level 14 verified in a PlonkWithoutPoseidon circuit
(`flagship.last_layer_trace`), proved with `prove_np` in the
Sha256MerkleChannel flavour.  With --streamed every level is proved by the
streamed provers instead (prover/stream.py: `prove_streamed` in the level's
flavour, `prove_np_streamed` for the last layer), which keep the base-domain
coefficients on the card and no LDE; the proofs are the same bytes.  After
each level:

- the port's verifier checks the proof on the card: levels 3-13 with
  `verify_batch` at batch 1, level 14 with `verify_sha256p31`, the last
  layer with `verify_sha256np`;
- the proof's `.bin` bytes (`flagship.proof_bytes`) must hash to the sha256
  docs/chain_artifacts.txt lists; the first mismatch ends the run with an
  error naming the level;
- the proof is written to DIR (default chain_out/, git-ignored) as
  `<name>.pkl` and `<name>.bin`.

Level 3 starts from the committed examples/data/level2-1.pkl; a run that
starts at a later level N reads this tool's own level-(N-1) proof from
DIR.  Each level prints one JSON line: the circuit's rows and Poseidon
invocations, the proof's log sizes and largest domain, circuit, prove and
verify seconds (`cold`: the first proof of that shape in the process), each
prover stage's seconds (the `progress` messages), the PoW bits and seconds,
the peak of `torch.cuda.max_memory_allocated`, K1, K2, scan and SHA-256
tree-level launches while proving and while verifying, and each resident
SHA-256 tree's hashing and digest copy-back seconds.  The native host code
(the streamed trees' top levels; the SHA grind of a proof on the host, on
a card it runs there) runs on RSTPU_OMP_THREADS OpenMP threads, 1 unless
set; each line names the count.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import pickle
import subprocess
import time

import torch

from ..models import flagship
from ..ops import launches
from ..proof.containers import PlonkWithoutPoseidonProof
from ..prover import commit
from ..prover.prove import prove
from ..prover.prove_np import prove_np
from ..prover.prove_sha256 import Sha256ProverChannel, prove_sha256p31
from ..prover.stream import prove_np_streamed, prove_streamed
from ..utils import native
from ..verifier import hints, verify, verify_sha256
from ..verifier.arrays import require_device, to_torch
from ..verifier.spec import NoPoseidonVerifierSpec, VerifierSpec
from .flavour_times import count_device_events

FIRST = 3  # level 2's proof is committed (examples/data/level2-1.pkl); level 3's is not
LAST = 15  # the last layer's place in the order
OUT = "chain_out"


def level_name(level: int) -> str:
    return flagship.LAST_LAYER_ARTIFACT if level == LAST else flagship.CHAIN_LEVELS[level][2]


def input_proof(level: int, out_dir: str):
    """The proof level `level` verifies when a run starts there: None for
    level 3 (chain_level_trace reads the committed level2-1.pkl), else this
    tool's own proof of the level before, from `out_dir`."""
    if level == FIRST:
        return None
    path = os.path.join(out_dir, f"{level_name(level - 1)}.pkl")
    if not os.path.exists(path):
        raise SystemExit(f"level {level} verifies {path}, which does not exist: prove level {level - 1} first")
    return flagship.load_artifact(path)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def build(level: int, proof_in):
    """(trace, PcsConfig, public inputs) of a level's circuit."""
    if level == LAST:
        return flagship.last_layer_trace(proof_in)
    trace, config, _ = flagship.chain_level_trace(level, proof_in)
    return trace, config, flagship.CHAIN_INPUTS


def prove_level(level: int, trace: dict, config, progress, dev, streamed: bool = False):
    if level == LAST:
        fn = prove_np_streamed if streamed else prove_np
        return fn(trace, config, progress, dev, channel=Sha256ProverChannel(), tree_cls=commit.Sha256DeviceTree)
    if level == flagship.SHA_LEVEL:
        if streamed:
            return prove_streamed(trace, config, progress, dev, channel=Sha256ProverChannel(),
                                  tree_cls=commit.Sha256DeviceTree)
        return prove_sha256p31(trace, config, progress, dev)
    return (prove_streamed if streamed else prove)(trace, config, progress, dev)


def verify_level(level: int, proof, inputs, dev) -> dict:
    """The port's verifier on the card: the twin of
    examples/recursion_chain.py:137-150 and examples/last_layer.py:174."""
    if level == LAST:
        return verify_sha256.verify_sha256np(proof, inputs, device=dev)
    if level == flagship.SHA_LEVEL:
        return verify_sha256.verify_sha256p31(proof, inputs, device=dev)
    spec = VerifierSpec.from_proof(proof)
    return verify.verify_batch(spec, to_torch(hints.prepare(spec, [proof]), dev), inputs)


def shape_of(proof) -> dict:
    """The proof's log sizes and its largest domain (the first FRI layer's)."""
    if isinstance(proof, PlonkWithoutPoseidonProof):
        spec = NoPoseidonVerifierSpec.for_rows(proof.log_size, proof.config)
        logs = dict(log_size=proof.log_size)
    else:
        spec = VerifierSpec.from_proof(proof)
        logs = dict(log_size_plonk=proof.log_size_plonk, log_size_poseidon=proof.log_size_poseidon)
    return dict(**logs, max_domain_log=spec.max_first_layer_log)


def timed_proof(prove_fn, dev, count_kernels: bool = False) -> tuple:
    """Run prove_fn(progress) on the card with the kernels' launch counts at
    0 and the peak memory reset.  Returns (proof, record): the wall, the
    peak of `torch.cuda.max_memory_allocated` and what the process held when
    the proof began (`start_bytes`: tables cached by earlier proofs; the
    proof's own peak is the difference), the launches, the native code's
    OpenMP threads, and each stage (a `progress` message) with its seconds,
    its own peak and the bytes held at its end.  With `count_kernels` the
    proof runs under a device-only torch.profiler trace and the record gains
    `cuda_kernels`, every kernel the card ran (eager torch's and the
    hand-written ones; copies and fills apart, as `copies_and_fills`), and
    of the trace's device time the SHA-256 kernel's (`sha256_ms`) and the
    copies' from the card to the host (`dtoh_ms`, the SHA-256 trees' digests
    among them): its wall then includes the trace's cost."""
    stages = []
    clock = [0.0]

    def progress(msg: str) -> None:
        torch.cuda.synchronize(dev)
        now = time.perf_counter()
        stages.append(dict(stage=msg, s=now - clock[0], peak_bytes=torch.cuda.max_memory_allocated(dev),
                           held_bytes=torch.cuda.memory_allocated(dev)))
        torch.cuda.reset_peak_memory_stats(dev)
        clock[0] = now

    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    start_bytes = torch.cuda.memory_allocated(dev)
    launches.reset()
    counted = {}
    start = clock[0] = time.perf_counter()
    if count_kernels:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            proof = prove_fn(progress)
            torch.cuda.synchronize(dev)
        prove_s = time.perf_counter() - start
        counted = count_device_events(torch, prof)
    else:
        proof = prove_fn(progress)
        torch.cuda.synchronize(dev)
        prove_s = time.perf_counter() - start
    peak = max([torch.cuda.max_memory_allocated(dev)] + [s["peak_bytes"] for s in stages])
    return proof, dict(
        prove_s=prove_s, peak_gib=peak / 2**30, peak_bytes=peak, start_bytes=start_bytes,
        own_peak_gib=(peak - start_bytes) / 2**30, prove_launches=launches.counts(),
        omp_threads=native.omp_threads(), stages=stages, **counted,
    )


def run_level(level: int, proof_in, out_dir, dev, seen: set, streamed: bool = False,
              count_kernels: bool = False) -> tuple:
    """Build, prove, verify and hold one level (1-15; levels 1-3 read their
    input from the repo when `proof_in` is None), with the streamed provers
    if `streamed`.  Writes the proof to `out_dir` unless it is None.
    Returns (proof, its JSON record); `count_kernels` as timed_proof."""
    name = level_name(level)
    t = time.perf_counter()
    trace, config, inputs = build(level, proof_in)
    circuit_s = time.perf_counter() - t
    rows, invocations = len(trace["a_wire"]), len(trace.get("flow_wires", ()))
    proof, timing = timed_proof(lambda progress: prove_level(level, trace, config, progress, dev, streamed), dev,
                                count_kernels)
    del trace

    launches.reset()
    t = time.perf_counter()
    checks = verify_level(level, proof, inputs, dev)
    failing = [k for k, v in checks.items() if not bool(v.all())]
    verify_s = time.perf_counter() - t
    if failing:
        raise SystemExit(f"level {level} ({name}): the port's verifier rejects the proof: {failing}")

    data = flagship.proof_bytes(proof)
    digest, want = hashlib.sha256(data).hexdigest(), flagship.expected_sha256(name)
    if digest != want:
        raise SystemExit(f"level {level} ({name}): the proof's bytes hash to {digest}, "
                         f"docs/chain_artifacts.txt lists {want}")
    if out_dir is not None:
        with open(os.path.join(out_dir, f"{name}.pkl"), "wb") as f:
            pickle.dump(proof, f)
        with open(os.path.join(out_dir, f"{name}.bin"), "wb") as f:
            f.write(data)

    shape = shape_of(proof)
    key = (tuple(sorted(shape.items())), config, streamed)
    cold = key not in seen
    seen.add(key)
    pow_s = sum(s["s"] for s in timing["stages"] if s["stage"] == "PoW ground")
    record = dict(
        level="last_layer" if level == LAST else level, artifact=name, streamed=streamed,
        channel="sha256" if level == LAST else "sha256_poseidon31" if level == flagship.SHA_LEVEL else "poseidon31",
        rows=rows, poseidon_invocations=invocations, public_inputs=len(inputs), **shape,
        pow_bits=config.pow_bits, fri=dataclasses.astuple(config.fri_config), circuit_s=circuit_s,
        cold=cold, verify_s=verify_s, pow_s=pow_s, verify_launches=launches.counts(),
        bytes=len(data), sha256=digest, matches_artifact=True, **timing,
    )
    return proof, record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--from", dest="first", type=int, default=FIRST, choices=range(FIRST, LAST + 1),
                    help=f"first level to prove ({LAST} is the last layer)")
    ap.add_argument("--to", dest="last", type=int, default=LAST, choices=range(FIRST, LAST + 1),
                    help="last level to prove")
    ap.add_argument("--out", default=OUT, help="directory of the proofs written and read")
    ap.add_argument("--streamed", action="store_true",
                    help="prove every level with the streamed provers (prover/stream.py)")
    args = ap.parse_args(argv)
    if args.first > args.last:
        ap.error("--from is after --to")
    dev = require_device("cuda")
    os.makedirs(args.out, exist_ok=True)
    card = card_line()
    print(json.dumps(dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                          levels=[args.first, args.last], streamed=args.streamed)), flush=True)

    start = time.perf_counter()
    proof, seen = input_proof(args.first, args.out), set()
    for level in range(args.first, args.last + 1):
        proof, record = run_level(level, proof, args.out, dev, seen, args.streamed)
        print(json.dumps(dict(**record, card=card)), flush=True)
    print(json.dumps(dict(chain="ok", levels=[args.first, args.last], wall_s=time.perf_counter() - start,
                          card=card)), flush=True)


if __name__ == "__main__":
    main()
