"""The program's own spans (floria_tpu_torch.timing) inside a run's
window, read per job.

The program records each span on time.perf_counter(), the clock of the
window (`run.window`) and of the device trace's marker. A record counts
when its whole span lies inside the window. A reading is None where the
program keeps no records (a tree without the recorder), where no record
of the names lies in the window, or where the recorder dropped a record
that may have lain in it.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional


def window_records(run) -> Optional[list]:
    """The program's records whose span lies inside the run's window."""
    from floria_tpu_torch import timing

    records = getattr(timing, "records", None)
    dropped = getattr(timing, "dropped", None)
    if records is None or dropped is None:
        return None
    recs = records()
    w0, w1 = run.window
    # The ring drops its oldest records first: none of the window's is
    # lost while the oldest record kept ended before the window.
    if dropped() and (not recs or recs[0].end >= w0):
        return None
    return [r for r in recs if w0 <= r.start and r.end <= w1]


def self_seconds(recs: List) -> Dict[int, float]:
    """{record id: its span's duration less the union of the intervals
    its children on its own thread cover}."""
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


def _named(run, names: Iterable[str]):
    recs = window_records(run)
    if not recs or not run.jobs:
        return None, None
    names = set(names)
    mine = [r for r in recs if r.name in names]
    return (recs, mine) if mine else (None, None)


def span_ms(run, names: Iterable[str]) -> Optional[float]:
    """Milliseconds per job of the spans named `names` in the window."""
    _recs, mine = _named(run, names)
    if mine is None:
        return None
    return sum(r.end - r.start for r in mine) / run.jobs * 1e3


def self_ms(run, names: Iterable[str]) -> Optional[float]:
    """Milliseconds per job of the self time of the spans named `names`:
    what no span under them on their own thread holds."""
    recs, mine = _named(run, names)
    if mine is None:
        return None
    own = self_seconds(recs)
    return sum(own[r.id] for r in mine) / run.jobs * 1e3


def count_per_job(run, key: str) -> Optional[float]:
    """The sum of count `key` over the window's spans, per job."""
    recs = window_records(run)
    if not recs or not run.jobs:
        return None
    found = [r.counts[key] for r in recs if key in r.counts]
    return sum(found) / run.jobs if found else None
