"""The device trace of a `--trace 1` window: torch.profiler over the card's
activity, read into busy time, per-kernel device time and idle gaps.

Device timestamps are put on the host's clock by a marker: right after a
synchronise, the harness notes the host time and launches one tiny
`torch.cuda._sleep` kernel (`spin_kernel`), whose device start then
stands for that host time. The marker is left out of every sum.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Tuple

MARKER = "spin_kernel"
TRANSFER_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]   # device seconds by kernel name
    transfer_s: float
    idle_gaps: List[Tuple[str, float]]  # idle seconds by harness span


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals, sorted."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_by_span(spans, gaps, window) -> List[Tuple[str, float]]:
    """The idle seconds of `gaps` attributed, instant by instant, to the
    innermost harness span open then (the one that started last, or was
    opened last at the same instant; "between jobs" where none is),
    summed by span name, largest first."""
    w0, w1 = window
    cuts = sorted({w0, w1} | {t for s in spans for t in (s.start, s.end)
                              if w0 < t < w1})
    totals: Dict[str, float] = {}
    gi = 0
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        best = None
        for s in spans:
            if s.start <= mid < s.end and (best is None
                                           or s.start >= best.start):
                best = s
        name = best.name if best is not None else "between jobs"
        while gi < len(gaps) and gaps[gi][1] <= a:
            gi += 1
        k = gi
        while k < len(gaps) and gaps[k][0] < b:
            idle = min(b, gaps[k][1]) - max(a, gaps[k][0])
            if idle > 0:
                totals[name] = totals.get(name, 0.0) + idle
            k += 1
    return sorted(totals.items(), key=lambda kv: -kv[1])


def summarize(events, marker_host: float, window: Tuple[float, float],
              spans) -> TraceSummary:
    """events: (name, start_s, end_s) on the device's clock. Returns the
    summary over the window (host times)."""
    mk = [e for e in events if MARKER in e[0]]
    if not mk:
        raise RuntimeError("the device trace holds no marker kernel: the "
                           "profiler recorded no device activity")
    off = marker_host - min(e[1] for e in mk)
    w0, w1 = window
    ivs, kernel_s, transfer_s = [], {}, 0.0
    for name, a, b in events:
        if MARKER in name:
            continue
        a, b = max(a + off, w0), min(b + off, w1)
        if b <= a:
            continue
        ivs.append((a, b))
        if name.startswith(TRANSFER_PREFIXES):
            transfer_s += b - a
        else:
            kernel_s[name] = kernel_s.get(name, 0.0) + (b - a)
    busy = merge(ivs)
    gaps, prev = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    return TraceSummary(
        window_s=w1 - w0, busy_s=sum(b - a for a, b in busy),
        kernel_s=kernel_s, transfer_s=transfer_s,
        idle_gaps=idle_by_span([s for s in spans if s.job >= 0], gaps,
                               window)[:10])


class Tracer:
    """Context manager around a measured window on the card `device`."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.marker_host = 0.0

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize(self.device)
        self.marker_host = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize(self.device)
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize(self.device)
        self.prof.__exit__(*exc)
        return False

    def device_events(self) -> List[Tuple[str, float, float]]:
        """(name, start_s, end_s) of every device activity recorded."""
        from torch.autograd import DeviceType

        return [(e.name(), e.start_ns() * 1e-9, e.end_ns() * 1e-9)
                for e in self.prof.profiler.kineto_results.events()
                if e.device_type() == DeviceType.CUDA]
