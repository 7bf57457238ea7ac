"""The traced slice of a run: ``torch.profiler`` over a few seconds of the
cell's own loop, reduced to what the per-layer metrics read.

- Device operations (kernels, copies, sets) with their spans, clipped to
  the slice; ``busy_s`` is the union of their spans (operations that
  overlap on two streams count once) and ``window_s`` the slice's length
  (the harness's ``portbench.traced`` span).
- Host CUDA runtime calls (``cuda*``/``cu*`` events of the host threads)
  other than the harness's own synchronisations.
- The breakdown the result line carries: the device operations that took
  most time, and the idle gaps summed by the innermost host span that was
  open at each gap's midpoint.
- Kernels counted and timed by name pattern: a replay of a CUDA graph can
  come back from the profiler with kernels missing, so the readers hold
  the kernels traced to the launches the program's wrappers counted
  (``work.KERNELS``), and a trace that lost kernels is reported, not read
  as idle time.
"""

from __future__ import annotations

import bisect
import heapq

WINDOW_SPAN = "portbench.traced"
SYNC_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize")


def short_name(name: str) -> str:
    """A kernel's name without its return type and parameter list."""
    name = name.split("(")[0]
    if name.startswith("void "):
        name = name[5:]
    return name.split("<")[0].strip()[:80] or name[:80]


def _annotation(e) -> bool:
    """Whether a device-side event is the mirror of a host span (a
    ``record_function`` range drawn on the device's timeline), not an
    operation that ran there."""
    kind = str(e.activity_type()) if hasattr(e, "activity_type") else ""
    return "annotation" in kind or bool(
        getattr(e, "is_user_annotation", lambda: False)())


class Trace:
    """Device operations and host events of one traced slice, in
    nanoseconds on the profiler's clock."""

    def __init__(self, events):
        self.device, self.host = [], []
        window = None
        for e in events:
            dev = str(e.device_type()).split(".")[-1]
            span = (e.start_ns(), e.start_ns() + e.duration_ns())
            if dev == "CUDA":
                if not _annotation(e):
                    self.device.append((e.name(), *span))
            elif dev == "CPU":
                if e.name() == WINDOW_SPAN:
                    window = span
                self.host.append((e.name(), *span))
        if window is None:
            raise RuntimeError("the trace holds no portbench.traced span")
        self.start, self.end = window
        self.device = [(n, max(a, self.start), min(b, self.end))
                       for n, a, b in self.device
                       if b > self.start and a < self.end]
        self.device.sort(key=lambda t: t[1])

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        return cls(prof.profiler.kineto_results.events())

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def busy_intervals(self) -> list:
        out = []
        for _, a, b in self.device:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def kernel_count(self, patterns) -> int:
        return sum(1 for n, _, _ in self.device
                   if any(p in n for p in patterns))

    def kernel_seconds(self, patterns) -> float:
        return sum(b - a for n, a, b in self.device
                   if any(p in n for p in patterns)) / 1e9

    def runtime_calls(self) -> int:
        """Host CUDA runtime and driver calls inside the slice, the
        harness's synchronisations left out."""
        return sum(1 for n, a, _ in self.host
                   if n.startswith("cu") and n not in SYNC_CALLS
                   and self.start <= a <= self.end)

    def device_ops(self, top: int = 10) -> list:
        by = {}
        for n, a, b in self.device:
            k = short_name(n)
            by[k] = by.get(k, 0) + (b - a)
        return [[k, v / 1e9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle device time summed by the innermost host span (the one that
        started last) open at each gap's midpoint; ``(none)`` where no host
        span was open."""
        gaps, t = [], self.start
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end > t:
            gaps.append((t, self.end))
        host = sorted((a, b, n) for n, a, b in self.host
                      if not n.startswith("cu") and n != WINDOW_SPAN)
        starts = [h[0] for h in host]
        by, open_, i = {}, [], 0
        for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (g0 + g1) / 2
            j = bisect.bisect_right(starts, mid)
            for a, b, n in host[i:j]:
                heapq.heappush(open_, (-a, b, n))
            i = max(i, j)
            # the top is the latest start; one that ended before mid never
            # covers a later gap, so it goes
            while open_ and open_[0][1] < mid:
                heapq.heappop(open_)
            name = open_[0][2] if open_ else "(none)"
            by[name] = by.get(name, 0) + (g1 - g0)
        return [[k, v / 1e9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]
