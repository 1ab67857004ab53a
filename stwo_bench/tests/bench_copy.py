"""A temporary copy of the benchmark with the tests' own cells added as
files and entries alone, and a CPU run of a cell in a fresh process."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
DATA = os.path.join(BENCH, "tests", "data")

TINY_CELLS = {
    "tiny.verify": ("recursive_16_15", "tiny_verify"),
    "tiny.prove": ("tiny_chain", "tiny_prove"),
    "tiny.prove_streamed": ("tiny_chain", "tiny_prove_streamed"),
}


def make_copy(dest: str) -> str:
    """dest/ with BENCHMARK.json and stwo_bench/ copied, the tests' traffic
    and configuration added as files and entries, and the program and the
    fixtures linked in.  Returns dest."""
    shutil.copytree(BENCH, os.path.join(dest, "stwo_bench"), ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("recursive_stwo_tpu_torch", "recursive_stwo_tpu"):
        os.symlink(os.path.join(ROOT, name), os.path.join(dest, name))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    shutil.copy(os.path.join(DATA, "tiny_chain.json"), os.path.join(dest, "stwo_bench", "configs"))
    bench["configs"].append({"name": "tiny_chain", "source": bench["configs"][1]["source"],
                             "file": "stwo_bench/configs/tiny_chain.json", "reduced": [], "why": "the tests' size"})
    for cell, (config, traffic) in TINY_CELLS.items():
        shutil.copy(os.path.join(DATA, f"{traffic}.json"), os.path.join(dest, "stwo_bench", "traffic"))
        bench["workloads"].append({"name": cell, "config": config, "traffic": traffic, "chips": 1, "why": "tests"})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in metric:
            kind = metric["name"].split("_")[0].split(".")[0]
            metric["workloads"] += [c for c in TINY_CELLS if c.split(".")[1].startswith(kind)]
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return dest


def run_cpu(root: str, workload: str, seed: int = 7, trace: int = 0, fault: str | None = None,
            seconds: float = 0.01, timeout: int = 600) -> dict:
    """One run of `workload` on the CPU in a fresh process that refuses JAX
    and the JAX package, with `fault` planted in its timed path ("control":
    control.py's hook; else tests/faults.py's); the result dict with
    `compared`, and the forbidden modules it loaded."""
    code = f"""
import json, sys
sys.path.insert(0, {os.path.join(root, 'stwo_bench', 'tests')!r})
import blocker
blocker.install()
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from stwo_bench.harness import cell, guard
hook = None
if {fault!r} == "control":
    import control_hook
    hook = control_hook.hook
elif {fault!r} is not None:
    import faults
    hook = faults.hook({fault!r})
out = cell.run({workload!r}, {seed}, {seconds}, bool({trace}), device="cpu", session_hook=hook)
out["forbidden"] = guard.forbidden_loaded()
print(json.dumps(out, default=str))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=timeout, cwd=root)
    if proc.returncode != 0:
        raise RuntimeError(f"{workload} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])
