"""One traced window of a cell, read by the program's spans, as one JSON line.

    python3 stwo_bench/span_report.py --workload NAME --seed N [--seconds S]

The window is run.py's with --trace 1 (the same set-up, profiler and
reference).  The line gives the share of the card's idle time inside the
benchmark's span of each unit (`prove` or `verify_batch`) that lies in gaps
whose middle a program span covers (harness/program_spans.py), the
breakdown's top idle gaps, each program span's occurrences and outermost
host seconds a unit, the traced window's seconds a unit and its calls' p95,
the per-layer metrics and whether the run was correct.  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from stwo_bench.harness import cell, program_spans, stats, trace as trace_mod  # noqa: E402


def report(workload: str, seed: int, seconds: float) -> dict:
    got = {}
    traced = trace_mod.traced

    def keep_trace(torch, fn):
        out, got["trace"] = traced(torch, fn)
        return out, got["trace"]

    def keep_record(session):
        window = session.window

        def kept(*args):
            got["record"] = window(*args)
            return got["record"]

        session.window = kept

    trace_mod.traced = keep_trace
    try:
        out = cell.run(workload, seed, seconds, True, session_hook=keep_record)
    finally:
        trace_mod.traced = traced
    tr, record = got["trace"], got["record"]
    units = record["units"]
    within = "prove" if record["kind"] == "prove" else "verify_batch"
    idle, covered = program_spans.idle_under_spans(tr, within)
    names = sorted({n[len(program_spans.PREFIX):] for n, _, _ in tr.host if n.startswith(program_spans.PREFIX)})
    line = {
        "workload": workload, "seed": seed, "correct": out["correct"], "units": units,
        "window_s_per_unit": record["window_s"] / units,
        "idle_s": idle, "idle_under_program_spans_s": covered, "share": covered / idle if idle else None,
        "idle_gaps": out["breakdown"]["idle_gaps"],
        "spans_per_unit": {n: [program_spans.count(tr, [n]) / units, program_spans.host_s(tr, [n]) / units]
                           for n in names},
        "span_events_per_unit": sum(n.startswith(program_spans.PREFIX) for n, _, _ in tr.host) / units,
        "metrics": {k: v["value"] for k, v in out["metrics"].items()},
        "busy_s": out["device"]["busy_s"], "window_s": out["device"]["window_s"],
    }
    if "latencies_s" in record:
        line["p95_ms"] = stats.p95(record["latencies_s"]) * 1e3
    return line


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args()
    print(json.dumps(report(args.workload, args.seed, args.seconds)), flush=True)
