"""The readers of the program's own spans (harness/program_spans.py and
the seven metrics that use it) on hand-built records: each returns its
hand-computed value per job, and None where the recorder dropped a record
that may have lain in the window or where the program keeps none."""

import pytest

from floria_tpu_torch import timing
from harness.manifest import Manifest

READERS = ("cli.estimate_ms", "phasing.pack_ms", "cli.unspanned_ms",
           "api.cache_ms", "api.window_ms", "api.upload_mb",
           "api.unspanned_ms")


class Run:
    window = (100.0, 200.0)
    jobs = 2


def _cli_job(t, ids):
    """One CLI job at time t: cli.main [t, t+10) holds the -e/-l pass
    (2.5 s) and pipeline.run (6 s), which holds ingest (0.4 s), packing
    (1 s) and the wait for the join (3.5 s), itself on a worker thread."""
    main, est, run, ing, pack, join, wait = ids
    R = timing.Record
    return [R(est, "cli.estimate", t + 0.5, t + 3.0, main, 1, 0, {}),
            R(ing, "ingest_realign", t + 3.6, t + 4.0, run, 1, 0, {}),
            R(pack, "phase.pack", t + 4.0, t + 5.0, run, 1, 0, {}),
            R(wait, "join.wait", t + 5.5, t + 9.0, run, 1, 0, {}),
            R(join, "join_outputs", t + 5.0, t + 9.5, run, 2, 0, {}),
            R(run, "pipeline.run", t + 3.5, t + 9.5, main, 1, 0, {}),
            R(main, "cli.main", t, t + 10.0, None, 1, 0, {})]


def _api_call(t, ids):
    """One instance-API call at time t: phase_instances [t, t+1) and
    refine_instances [t+1, t+1.5), each with its cache (0.2 s, 150 MB)."""
    pi, c1, w1, w2, bl, bp, ri, c2, ul, up = ids
    R = timing.Record
    return [R(c1, "beam.cache_upload", t, t + 0.2, pi, 1, 0,
              {"h2d_bytes": 150e6}),
            R(w1, "dispatch.window", t + 0.3, t + 0.4, pi, 1, 0, {}),
            R(w2, "dispatch.window", t + 0.4, t + 0.45, pi, 1, 0, {}),
            R(bl, "beam.launch", t + 0.5, t + 0.6, pi, 1, 0,
              {"h2d_bytes": 1000}),
            R(bp, "beam.pull", t + 0.6, t + 0.9, pi, 1, 0, {}),
            R(pi, "phase_instances", t, t + 1.0, None, 1, 0, {}),
            R(c2, "beam.cache_upload", t + 1.0, t + 1.2, ri, 1, 0,
              {"h2d_bytes": 150e6}),
            R(ul, "upem.launch", t + 1.2, t + 1.3, ri, 1, 0,
              {"h2d_bytes": 2000}),
            R(up, "upem.pull", t + 1.3, t + 1.45, ri, 1, 0, {}),
            R(ri, "refine_instances", t + 1.0, t + 1.5, None, 1, 0, {})]


def _records():
    """A warm job before the window, then two of each in it."""
    recs, n = [], 0
    for t in (80.0, 120.0, 140.0):
        recs += _cli_job(t, range(n, n + 7))
        recs += _api_call(t + 11.0, range(n + 7, n + 17))
        n += 17
    return recs


WANT = {"cli.estimate_ms": 2500.0, "phasing.pack_ms": 1000.0,
        # cli.main 10 - 2.5 - 6; pipeline.run 6 - 0.4 - 1 - 3.5 (the
        # join's own thread takes nothing from it)
        "cli.unspanned_ms": 1500.0 + 1100.0,
        "api.cache_ms": 400.0, "api.window_ms": 150.0,
        "api.upload_mb": 300.003,
        # phase_instances 1 - 0.75; refine_instances 0.5 - 0.45
        "api.unspanned_ms": 250.0 + 50.0}


@pytest.fixture
def spans(monkeypatch):
    state = {"records": _records(), "dropped": 0}
    monkeypatch.setattr(timing, "records", lambda: list(state["records"]))
    monkeypatch.setattr(timing, "dropped", lambda: state["dropped"])
    return state


@pytest.mark.parametrize("name", READERS)
def test_a_reader_gives_its_value_per_job(spans, name):
    assert Manifest().reader(name)(Run()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_nothing_once_the_window_lost_a_record(spans, name):
    read = Manifest().reader(name)
    # Dropped records were older than the oldest kept one, which ended
    # before the window: nothing of the window is lost.
    spans["dropped"] = 5
    assert read(Run()) == pytest.approx(WANT[name])
    # The oldest kept record ends inside the window: one that ended in
    # it may be gone.
    spans["records"] = [r for r in spans["records"] if r.start >= 100.0]
    assert read(Run()) is None


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_nothing_without_the_recorder(monkeypatch, name):
    monkeypatch.delattr(timing, "records")
    assert Manifest().reader(name)(Run()) is None


def test_the_readers_are_in_the_manifest():
    m = Manifest()
    cli = {x["name"] for x in m.metrics_of("config4.cli", trace=True)}
    api = {x["name"] for x in m.metrics_of("ecoli2.blocks", trace=True)}
    assert {"cli.estimate_ms", "phasing.pack_ms", "cli.unspanned_ms"} <= cli
    assert {"api.cache_ms", "api.window_ms", "api.upload_mb",
            "api.unspanned_ms"} <= api
