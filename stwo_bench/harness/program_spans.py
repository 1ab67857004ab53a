"""The program's own spans in a traced window, and the arithmetic the
readers of the metrics that read them share.

The program opens host ranges named PREFIX + name
(recursive_stwo_tpu_torch/utils/spans.py) with function scope, so the
profiler places them on the clock of the card's events and makes no copy of
them on the card's timeline; harness/trace.py keeps them among the window's
host events (`Trace.host`).  Nothing here synchronizes: every number comes
from the trace's own timestamps.  An occurrence inside another occurrence
of the names read counts once, as the outer one.  Each function returns
None when the trace holds none of the names, so a renamed span leaves its
metric out rather than reading 0.
"""

from __future__ import annotations

import bisect

from . import stats

PREFIX = "rstpu."


def occurrences(trace, names) -> list:
    """The outermost [start, end) occurrences, sorted, of the spans
    PREFIX + n for n in `names`."""
    wanted = {PREFIX + n for n in names}
    out = []
    for s, e in sorted((s, e) for name, s, e in trace.host if name in wanted):
        if out and s < out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def host_s(trace, names) -> float | None:
    """Host seconds inside the spans."""
    found = occurrences(trace, names)
    return sum(e - s for s, e in found) / 1e9 if found else None


def idle_s(trace, names) -> float | None:
    """Seconds inside the spans in which no operation ran on the card."""
    found = occurrences(trace, names)
    if not found:
        return None
    device = [(s, e) for _, s, e in trace.device_ops]
    return sum((e - s) - stats.covered(device, s, e) for s, e in found) / 1e9


def count(trace, names) -> int | None:
    """How many times the spans were opened."""
    found = occurrences(trace, names)
    return len(found) if found else None


def idle_under_spans(trace, within: str) -> tuple:
    """(idle seconds, of them those under a program span) inside the
    benchmark's spans named `within`: the card's idle gaps there, each put
    wholly under a program span if the span covers the gap's middle, as
    `Trace.idle_by_host` names a gap by what the host did at its middle."""
    program = stats.union([(s, e) for name, s, e in trace.host if name.startswith(PREFIX)])
    starts = [s for s, _ in program]
    device = [(s, e) for _, s, e in trace.device_ops]
    idle = covered = 0
    for name, lo, hi in trace.spans:
        if name != within:
            continue
        for s, e in stats.gaps(device, lo, hi):
            idle += e - s
            k = bisect.bisect_right(starts, (s + e) // 2) - 1
            covered += (e - s) if k >= 0 and (s + e) // 2 < program[k][1] else 0
    return idle / 1e9, covered / 1e9
