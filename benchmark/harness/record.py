"""What one run records for the metric readers: host spans, counters, the
program's stage times per job, and the device trace's summary."""

from __future__ import annotations

import dataclasses
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class Span:
    name: str
    start: float           # host perf_counter seconds
    end: float
    parent: Optional[int]  # index of the enclosing span on its thread
    job: int               # the window's job this span belongs to


class Record:
    """Spans, counters and per-job program readings of one run. Spans are
    recorded only inside the measured window (`job` >= 0)."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, float] = {}
        self.stage_times: List[Dict[str, float]] = []
        self.jobs = 0
        self.setup_s = 0.0
        self.window: Tuple[float, float] = (0.0, 0.0)
        self.trace = None          # trace.TraceSummary of a traced run
        self.job = -1
        self._stack = threading.local()
        self._lock = threading.Lock()

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def count(self, name: str, n: float) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + n

    @contextmanager
    def span(self, name: str):
        stack = getattr(self._stack, "s", None)
        if stack is None:
            stack = self._stack.s = []
        parent = stack[-1] if stack else None
        job = self.job
        t0 = time.perf_counter()
        with self._lock:
            idx = len(self.spans)
            self.spans.append(Span(name, t0, t0, parent, job))
        stack.append(idx)
        try:
            yield
        finally:
            stack.pop()
            self.spans[idx].end = time.perf_counter()

    def wrap(self, label: str, fn):
        """`fn` with each call recorded as a span named `label`."""
        def wrapped(*a, **k):
            with self.span(label):
                return fn(*a, **k)
        return wrapped

    def span_walls(self, name: str) -> List[float]:
        return [s.end - s.start for s in self.spans
                if s.name == name and s.job >= 0]
