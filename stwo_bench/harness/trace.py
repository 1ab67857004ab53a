"""The traced window: torch.profiler over the host and the card, reduced to
the card's busy intervals, its kernels and the host's spans.

The benchmark's own spans are `record_function` ranges named SPAN + name;
the profiler puts them and the card's operations on one clock.  The raw
events are read from the profiler's results (prof.profiler.kineto_results),
which is not a public API of torch: a release that moves it raises here,
naming itself.  A trace with no device event is taken again (CUPTI now and
then returns none), up to three times.
"""

from __future__ import annotations

import contextlib

from . import stats

SPAN = "bench#"
COPIES = ("Memcpy", "Memset")


@contextlib.contextmanager
def span(name: str, on: bool):
    """A host span of the benchmark's own, recorded only in a traced run."""
    if not on:
        yield
        return
    from torch.profiler import record_function

    with record_function(SPAN + name):
        yield


class Trace:
    """One traced window: device operations as (name, start_ns, end_ns),
    kernels apart from copies and fills, the benchmark's spans and the
    other host events as (name, start_ns, end_ns), and the window's extent,
    from the first of the benchmark's spans to the last."""

    def __init__(self, events):
        from torch.autograd import DeviceType

        self.device_ops, self.spans, self.host = [], [], []
        for e in events:
            item = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            if item[0].startswith(SPAN):
                # a span's range, and its copy on the card's timeline (a user annotation, no operation)
                if e.device_type() != DeviceType.CUDA:
                    self.spans.append((item[0][len(SPAN):], item[1], item[2]))
            elif e.device_type() == DeviceType.CUDA:
                self.device_ops.append(item)
            else:
                self.host.append(item)
        self.kernels = [op for op in self.device_ops if not op[0].startswith(COPIES)]
        starts = [s for _, s, _ in self.spans] or [s for _, s, _ in self.device_ops]
        ends = [e for _, _, e in self.spans] or [e for _, _, e in self.device_ops]
        self.lo, self.hi = min(starts), max(ends)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the card."""
        return stats.covered([(s, e) for _, s, e in self.device_ops], self.lo, self.hi) / 1e9

    @property
    def kernel_s(self) -> float:
        """The kernels' summed device time."""
        return sum(e - s for _, s, e in self.kernels) / 1e9

    def top_ops(self, n: int = 10) -> list:
        by_name = {}
        for name, s, e in self.device_ops:
            by_name[name] = by_name.get(name, 0) + (e - s)
        return [[k, v / 1e9] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_host(self, n: int = 10) -> list:
        """The card's idle time in the window, by what the host was doing at
        the middle of each gap: the innermost host event there (a torch op or
        a runtime call), under the innermost of the benchmark's spans."""
        gaps = stats.gaps([(s, e) for _, s, e in self.device_ops], self.lo, self.hi)
        mids = [(s + e) // 2 for s, e in gaps]
        outer = _innermost_at(self.spans, mids)
        inner = _innermost_at(self.host, mids)
        out = {}
        for (s, e), o, i in zip(gaps, outer, inner):
            key = f"{o or 'outside the spans'} / {i or 'python'}"
            out[key] = out.get(key, 0) + (e - s)
        return [[k, v / 1e9] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:n]]


def _innermost_at(items: list, times: list) -> list:
    """For each time (ascending), the name of the latest-started item that
    covers it: one sweep with a stack of open items (a thread's events nest)."""
    ordered = sorted(items, key=lambda it: (it[1], -it[2]))
    out, stack, k = [], [], 0
    for t in times:
        while k < len(ordered) and ordered[k][1] <= t:
            stack.append(ordered[k])
            k += 1
        while stack and stack[-1][2] <= t:
            stack.pop()
        out.append(next((it[0] for it in reversed(stack) if it[2] > t), None))
    return out


def traced(torch, fn):
    """(fn's result, Trace) of fn run under the profiler, host and card."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        try:
            events = prof.profiler.kineto_results.events()
        except AttributeError as exc:
            raise RuntimeError(f"torch {torch.__version__}: the profiler's raw events "
                               "(prof.profiler.kineto_results.events()) cannot be read") from exc
        trace = Trace(events)
        if trace.device_ops:
            return out, trace
    raise RuntimeError("three traces in a row recorded no operation on the card")
