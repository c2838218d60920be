"""api.window_blocks (metrics/api.window_blocks.py) on hand-built
records: the `window_blocks` counts of the `dispatch.window` spans per
call, and None where the recorder dropped a record that may have lain in
the window, where the program keeps none, or where no span counts it."""

import pytest

from floria_tpu_torch import timing
from harness.manifest import Manifest
from test_harness_program_spans import Run, _records

# The blocks each of a call's two dispatch windows read.
COUNTS = (1, 0)


def _counted(recs):
    out, k = [], 0
    for r in recs:
        if r.name == "dispatch.window":
            r = r._replace(counts={"window_blocks": COUNTS[k % 2]})
            k += 1
        out.append(r)
    return out


@pytest.fixture
def spans(monkeypatch):
    state = {"records": _counted(_records()), "dropped": 0}
    monkeypatch.setattr(timing, "records", lambda: list(state["records"]))
    monkeypatch.setattr(timing, "dropped", lambda: state["dropped"])
    return state


def _read():
    return Manifest().reader("api.window_blocks")(Run())


def test_window_blocks_per_call(spans):
    # Two calls in the window, each 1 + 0 blocks; the warm call before
    # the window is left out.
    assert _read() == pytest.approx(sum(COUNTS))
    spans["dropped"] = 5
    assert _read() == pytest.approx(sum(COUNTS))


def test_window_blocks_reads_nothing_once_the_window_lost_a_record(spans):
    spans["dropped"] = 5
    spans["records"] = [r for r in spans["records"] if r.start >= 100.0]
    assert _read() is None


def test_window_blocks_reads_nothing_where_no_span_counts_it(spans):
    spans["records"] = _records()
    assert _read() is None


def test_window_blocks_reads_nothing_without_the_recorder(monkeypatch):
    monkeypatch.delattr(timing, "records")
    assert _read() is None


def test_window_blocks_is_in_the_manifest():
    m = Manifest()
    api = {x["name"] for x in m.metrics_of("ecoli2.blocks", trace=True)}
    cli = {x["name"] for x in m.metrics_of("config4.cli", trace=True)}
    assert "api.window_blocks" in api and "api.window_blocks" not in cli
