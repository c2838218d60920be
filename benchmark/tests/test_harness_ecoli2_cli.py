"""The `ecoli2.cli` cell in the manifest, and the readers of realignment's
spans and counts (metrics/realign.*.py, metrics/k5.roofline_pct.py) on
hand-built records: each returns its hand-computed value per job, the
roofline share the repository's own K5 count (chip_smoke.py `k5_bound`)
gives, and None where it has nothing to read."""

import types

import pytest
import torch

from chip_smoke import k5_bound
from floria_tpu_torch import timing
from harness.manifest import Manifest

CLI_METRICS = {"cli.pre_run_ms", "ingest.ms", "phasing.ms", "join.ms",
               "kernels.cli.device_ms", "device.cli.idle_pct",
               "cli.estimate_ms", "phasing.pack_ms", "cli.unspanned_ms"}
K5_METRICS = {"realign.ms", "realign.k5_ms", "realign.k5_jobs",
              "k5.roofline_pct"}
K5_KERNEL = "void (anonymous namespace)::nw_best_kernel<2>(...)"


def test_ecoli2_cli_reports_the_cli_metrics_and_realignments():
    m = Manifest()
    cell = m.cell("ecoli2.cli")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "ecoli2_cli", "cli", 1)
    assert m.configs["ecoli2_cli"]["reduced"] == []
    e2e = {x["name"] for x in m.metrics_of("ecoli2.cli", trace=False)}
    assert e2e == {"cli_reads_per_s", "setup_s"}
    traced = {x["name"] for x in m.metrics_of("ecoli2.cli", trace=True)}
    assert traced == CLI_METRICS | K5_METRICS
    config4 = {x["name"] for x in m.metrics_of("config4.cli", trace=True)}
    assert config4 == CLI_METRICS
    blocks = {x["name"] for x in m.metrics_of("ecoli2.blocks", trace=True)}
    assert not blocks & K5_METRICS


def test_ecoli2_cli_runs_the_ecoli2_community_with_the_cli_defaults():
    m = Manifest()
    cli, blocks = m.config("ecoli2_cli"), m.config("ecoli2")
    assert cli["sim"] == blocks["sim"]
    assert cli["cli"] == {"pool": 2, "args": []}
    assert cli["entry"]["source"] != blocks["entry"]["source"]
    assert cli["entry"]["file"] != blocks["entry"]["file"]


def _inputs(n, case):
    """K5's inputs for n jobs over 5,000 SNP rows of 4 alleles, tried at
    2 (`operations`: nal 1-4; `bytes`: nal 0, so no allele is tried)."""
    g = torch.Generator().manual_seed(n)
    t, a = 5000, 4
    nal = (torch.randint(1, a + 1, (n,), generator=g, dtype=torch.int32)
           if case == "operations" else torch.zeros(n, dtype=torch.int32))
    return (torch.randint(0, 256, (n, 16), generator=g, dtype=torch.uint8),
            torch.randint(0, t, (n,), generator=g, dtype=torch.int32), nal,
            torch.randint(0, 16, (t, 32), generator=g, dtype=torch.uint8),
            torch.randint(0, 16, (t, a), generator=g, dtype=torch.uint8), 2)


def _counts(inputs):
    """The counts the program gives the nw_best span of these inputs."""
    q, si, nal, ref_tab, al_tab, a_max = inputs
    return {"nw_jobs": len(q),
            "nw_alleles": int(nal.clamp(max=a_max).sum()),
            "h2d_bytes": sum(x.numel() * x.element_size()
                             for x in (q, si, nal, ref_tab, al_tab))}


# Two jobs' partitions in the window, one before it (the warm job).
SIZES = (40_000, 70_000, 90_000)
STARTS = (80.0, 120.0, 140.0)


def _records(case, counted=True):
    """Per job at t: ingest_realign [t, t+1) holding realign.host_prep
    (0.2 s), realign.device (0.5 s) with realign.device.nw_best (0.4 s)
    in it, and realign.scatter (0.1 s)."""
    R = timing.Record
    recs = []
    for k, (t, n) in enumerate(zip(STARTS, SIZES)):
        i = 10 * k
        counts = _counts(_inputs(n, case)) if counted else {}
        recs += [R(i + 1, "realign.host_prep", t, t + 0.2, i, 1, k,
                   {"realign_jobs": 8 * n, "nw_left": 2 * n}
                   if counted else {}),
                 R(i + 3, "realign.device.nw_best", t + 0.25, t + 0.65,
                   i + 2, 1, k, counts),
                 R(i + 2, "realign.device", t + 0.2, t + 0.7, i, 1, k, {}),
                 R(i + 4, "realign.scatter", t + 0.7, t + 0.8, i, 1, k,
                   {}),
                 R(i, "ingest_realign", t, t + 1.0, None, 1, k, {})]
    return recs


def _run(trace=True, kernel_s=None):
    summary = types.SimpleNamespace(kernel_s={K5_KERNEL: 0.5e-3,
                                              "beam_scan_kernel": 0.1}
                                    if kernel_s is None else kernel_s)
    return types.SimpleNamespace(window=(100.0, 200.0), jobs=2,
                                 trace=summary if trace else None)


@pytest.fixture
def spans(monkeypatch):
    state = {"records": _records("operations"), "dropped": 0}
    monkeypatch.setattr(timing, "records", lambda: list(state["records"]))
    monkeypatch.setattr(timing, "dropped", lambda: state["dropped"])
    return state


def _read(name, run=None):
    return Manifest().reader(name)(run or _run())


def test_the_realignment_readers_per_job(spans):
    assert _read("realign.ms") == pytest.approx((200 + 500 + 100) * 2 / 2)
    assert _read("realign.k5_ms") == pytest.approx(400.0)
    assert _read("realign.k5_jobs") == pytest.approx(sum(SIZES[1:]) / 2)


@pytest.mark.parametrize("case,by", [("operations", "operations"),
                                     ("bytes", "bytes")])
def test_k5_roofline_is_the_repositorys_count(spans, case, by):
    spans["records"] = _records(case)
    want_s = 0.0
    for n in SIZES[1:]:
        ms, got_by = k5_bound(*_inputs(n, case))
        assert got_by == by
        want_s += ms * 1e-3
    assert _read("k5.roofline_pct") == pytest.approx(
        100.0 * want_s / 0.5e-3, rel=1e-12)


def test_k5_roofline_reads_nothing_without_a_trace_counts_or_k5(spans):
    assert _read("k5.roofline_pct", _run(trace=False)) is None
    assert _read("k5.roofline_pct",
                 _run(kernel_s={"beam_scan_kernel": 0.1})) is None
    spans["records"] = _records("operations", counted=False)
    assert _read("k5.roofline_pct") is None
    assert _read("realign.k5_jobs") is None
    # The spans are there without the counts: the times still read.
    assert _read("realign.k5_ms") == pytest.approx(400.0)


def test_the_readers_read_nothing_without_the_recorder(monkeypatch):
    monkeypatch.delattr(timing, "records")
    for name in K5_METRICS:
        assert _read(name) is None, name
