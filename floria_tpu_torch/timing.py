"""The port's span recorder: where a run spends its time on the host.

    with timing.span("phase.pack"):
        ...
        timing.count("h2d_bytes", n)

    @timing.span("phase_instances")
    def phase_instances(...): ...

`span(name)` times a block on `time.perf_counter()`, the clock a caller's
own window and a device trace's marker can be put on. Each finished span
is one `Record`: its name, start, end, the enclosing span on its thread
(`parent`), the thread, its `job` and the `counts` that `count(key, n)`
added while it was the innermost open span. A span opened where no span
is open is a root: it starts a new job id, which every span under it
carries. A thread a job starts takes the job and the parent along with
`adopt(current())`.

Records go into a ring of `RING` records; when it is full the oldest goes
and `dropped()` counts it, so recording never fails and never grows. It
is always on: a span costs a few microseconds, and spans stand at layer
and dispatch boundaries only, never in a loop over blocks, reads or SNPs.

`STAGE_TIMES` holds the seconds by span name of the newest root's job
(the root included, summed over threads); a root clears it when it
starts. When a root ends and the "floria_tpu" logger is at DEBUG (the
CLI's --debug or --trace), one line per span name of its job is logged:
count, total ms, self ms (less the time its children on its own thread
cover) and summed counts.
"""

from __future__ import annotations

import functools
import itertools
import logging
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, NamedTuple, Optional

RING = 1 << 16

log = logging.getLogger("floria_tpu")


class Record(NamedTuple):
    id: int
    name: str
    start: float                 # time.perf_counter() seconds
    end: float
    parent: Optional[int]        # id of the enclosing span
    thread: int                  # threading.get_ident() of its thread
    job: int
    counts: Dict[str, float]


class Span:
    """An open span (what `span(name)` returns and `current()` gives)."""

    __slots__ = ("recorder", "name", "id", "start", "parent", "job",
                 "counts")

    def __init__(self, recorder: "Recorder", name: str):
        self.recorder = recorder
        self.name = name

    def __enter__(self) -> "Span":
        rec = self.recorder
        stack = rec._stack()
        self.id = next(rec._ids)
        self.counts = {}
        if stack:
            self.parent, self.job = stack[-1].id, stack[-1].job
        else:
            self.parent, self.job = None, next(rec._jobs)
            with rec._lock:
                rec._job = self.job
                rec.stage_times.clear()
        stack.append(self)
        self.start = rec.clock()
        return self

    def __exit__(self, *exc) -> bool:
        rec = self.recorder
        end = rec.clock()
        rec._stack().pop()
        # tuple.__new__ skips the namedtuple's own __new__, a Python call.
        record = tuple.__new__(Record, (self.id, self.name, self.start, end,
                                        self.parent, threading.get_ident(),
                                        self.job, self.counts))
        with rec._lock:
            if len(rec.ring) == rec.ring.maxlen:
                rec.dropped += 1
            rec.ring.append(record)
            if self.job == rec._job:
                rec.stage_times[self.name] = (
                    rec.stage_times.get(self.name, 0.0) + end - self.start)
        if self.parent is None and log.isEnabledFor(logging.DEBUG):
            rec._export(self.job)
        return False

    def seconds(self) -> float:
        """Seconds since the span opened."""
        return self.recorder.clock() - self.start

    def __call__(self, fn):
        """As a decorator: each call of `fn` in a span of this name."""
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with self.recorder.span(self.name):
                return fn(*args, **kwargs)
        return spanned


class Recorder:
    """Spans of one process (the module's functions use one instance);
    `clock` and `capacity` are there for tests."""

    def __init__(self, capacity: int = RING, clock=time.perf_counter):
        self.clock = clock
        self.ring: deque = deque(maxlen=capacity)
        self.dropped = 0
        self.stage_times: Dict[str, float] = {}
        self._job = 0                  # the newest root's job
        self._ids = itertools.count(1)
        self._jobs = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    def _stack(self) -> List[Span]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def span(self, name: str) -> Span:
        return Span(self, name)

    def count(self, key: str, n: float) -> None:
        """Add n to `key` in the innermost open span's counts (kept by
        none when no span is open)."""
        stack = self._stack()
        if stack:
            counts = stack[-1].counts
            with self._lock:
                counts[key] = counts.get(key, 0) + n

    def current(self) -> Optional[Span]:
        """The innermost open span of this thread, for `adopt`."""
        stack = self._stack()
        return stack[-1] if stack else None

    @contextmanager
    def adopt(self, ctx: Optional[Span]):
        """Spans opened inside, on this thread, are children of `ctx` (a
        span of another thread, from `current()`) in its job."""
        if ctx is None:
            yield
            return
        stack = self._stack()
        stack.append(ctx)
        try:
            yield
        finally:
            stack.pop()

    def records(self) -> List[Record]:
        """The ring's records, oldest first."""
        with self._lock:
            return list(self.ring)

    def _export(self, job: int) -> None:
        recs = [r for r in self.records() if r.job == job]
        own = self_seconds(recs)
        rows: Dict[str, list] = {}
        for r in recs:
            row = rows.setdefault(r.name, [0, 0.0, 0.0, {}])
            row[0] += 1
            row[1] += r.end - r.start
            row[2] += own[r.id]
            for k, v in r.counts.items():
                row[3][k] = row[3].get(k, 0) + v
        for name, (n, total, own_s, counts) in sorted(
                rows.items(), key=lambda kv: -kv[1][1]):
            log.debug("span %s: %d x, %.3f ms, self %.3f ms%s", name, n,
                      total * 1e3, own_s * 1e3,
                      "".join(f", {k} {v:g}" for k, v in counts.items()))


def self_seconds(recs: List[Record]) -> Dict[int, float]:
    """{record id: its duration less the union of the intervals its
    children on its own thread cover}."""
    kids: Dict[tuple, list] = {}
    for r in recs:
        kids.setdefault((r.parent, r.thread), []).append((r.start, r.end))
    out = {}
    for r in recs:
        covered, reach = 0.0, r.start
        for a, b in sorted(kids.get((r.id, r.thread), ())):
            a, b = max(a, reach), min(b, r.end)
            if b > a:
                covered += b - a
                reach = b
        out[r.id] = r.end - r.start - covered
    return out


_RECORDER = Recorder()
STAGE_TIMES = _RECORDER.stage_times
span = _RECORDER.span
count = _RECORDER.count
current = _RECORDER.current
adopt = _RECORDER.adopt
records = _RECORDER.records


def dropped() -> int:
    """Records the ring has dropped since the process started."""
    return _RECORDER.dropped
