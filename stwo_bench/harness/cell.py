"""One run of one cell: set-up, the measured (or traced) window, the
comparison with the plain reference, and the result's last line.

The cell's driver (drivers/<name>.py, named by its traffic mix) owns the
entry it drives; this module owns what every cell shares: the clock of the
set-up, the profiler, the memory peak, the metric readers and the line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

from . import guard, registry, trace as trace_mod


class Spans:
    """The benchmark's host spans: summed seconds by name on the host clock,
    and in a traced run `record_function` ranges the trace places."""

    def __init__(self, traced: bool):
        self.traced = traced
        self.seconds = {}

    def __call__(self, name: str):
        return _Span(self, name)


class _Span:
    def __init__(self, owner: Spans, name: str):
        self.owner, self.name = owner, name
        self.ctx = trace_mod.span(name, owner.traced)

    def __enter__(self):
        self.ctx.__enter__()
        self.t = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t
        self.owner.seconds[self.name] = self.owner.seconds.get(self.name, 0.0) + dt
        return self.ctx.__exit__(*exc)


def apply_env(config: dict) -> None:
    """The environment the configuration states for the program (set before
    the program is imported, which reads it at load time)."""
    for key, value in config.get("env", {}).items():
        os.environ[key] = str(value)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run(workload: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
        started: float | None = None, bench: dict | None = None, session_hook=None) -> dict:
    """The result of one run as a dict (the last line's keys, and
    `compared`).  `session_hook(session)` may replace parts of the timed
    path (the control and the fault tests do)."""
    started = time.perf_counter() if started is None else started
    bench = bench or registry.load_benchmark()
    cell = registry.workload(bench, workload)
    config = registry.config(bench, cell["config"])
    traffic = registry.traffic(cell["traffic"])
    apply_env(config)
    import torch

    session = registry.driver(traffic["driver"]).Session(config, traffic, seed, device)
    if session_hook is not None:
        session_hook(session)
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - started

    def window():
        spans = Spans(traced)
        return session.window(seconds, spans), spans

    tr = None
    if traced:
        (record, spans), tr = trace_mod.traced(torch, window)
    else:
        record, spans = window()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    judged = time.perf_counter()
    verdict = session.judge()
    judge_s = time.perf_counter() - judged

    record.update(setup_s=setup_s, spans=spans.seconds, trace=tr, work=verdict["work"])
    out = {"correct": verdict["correct"], "attempted": verdict["attempted"], "failed": verdict["failed"],
           "metrics": {}}
    for m in registry.metrics_of(bench, workload, per_layer=traced):
        value = registry.reader(m["name"])(record)
        if value is not None:
            out["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    out["device"] = {"platform": "gpu" if device == "cuda" else device,
                     "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
                     "count": cell["chips"], "memory_peak_bytes": peak}
    if tr is not None:
        out["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        names = record.get("span_names", {})
        idle = [[" / ".join(names.get(p, p) for p in k.split(" / ")), v] for k, v in tr.idle_by_host()]
        out["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": idle}
    out["notes"] = dict(getattr(session, "notes", {}), judge_s=judge_s)
    out["compared"] = verdict["compared"]
    return out


def main(args, started: float) -> int:
    bench = registry.load_benchmark()
    cell = registry.workload(bench, args.workload)
    apply_env(registry.config(bench, cell["config"]))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload}: needs {cell['chips']} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", started, bench)
    found = guard.forbidden_loaded()
    if found:
        print(f"{args.workload}: the run loaded {found}; the benchmark may load neither JAX nor the JAX "
              "package", file=sys.stderr)
        return 3
    out["device"]["power_limit"] = power_limit()
    print(f"notes {json.dumps(out.pop('notes'))}", file=sys.stderr)
    for name, c in out["compared"].items():
        print(f"compared {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
