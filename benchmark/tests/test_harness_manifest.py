"""BENCHMARK.json against the contract, and the harness finding every
file by name."""

import json
import os
import re
import shutil

from conftest import BENCH, ROOT

from harness.manifest import Manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def names_and_units(data):
    """Every name and unit the manifest holds."""
    names = [c["name"] for c in data["configs"]]
    names += [k for c in data["configs"] for k in c["reduced"]]
    for w in data["workloads"]:
        names += [w["name"], w["config"], w["traffic"]]
    metrics = data["end_to_end"] + data["per_layer"]
    names += [m["name"] for m in metrics]
    return {"names": names, "units": [m["unit"] for m in metrics]}


def _data():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_names_and_units_keep_to_the_allowed_characters():
    got = names_and_units(_data())
    assert got["names"] and got["units"]
    for name in got["names"]:
        assert NAME.match(name), name
    for unit in got["units"]:
        assert UNIT.match(unit), unit


def test_manifest_keys_and_limits():
    d = _data()
    assert set(d) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= d["run_seconds"] <= 51
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    names = {w["name"] for w in d["workloads"]}
    assert any(m["name"] == "setup_s" for m in d["end_to_end"])
    for m in d["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", names)) <= names
    e2e = {m["name"] for m in d["end_to_end"]}
    for m in d["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
        assert set(m.get("workloads", names)) <= names


def test_every_cell_finds_its_files_and_reports_what_it_must():
    m = Manifest()
    for cell in m.cells:
        w = m.cell(cell)
        assert m.config(w["config"])["name"] == w["config"]
        assert "driver" in m.traffic(w["traffic"])
        e2e = m.metrics_of(cell, trace=False)
        layer = m.metrics_of(cell, trace=True)
        assert "setup_s" in {x["name"] for x in e2e} and len(e2e) >= 2
        assert layer
        reported = {x["name"] for x in e2e}
        for x in e2e + layer:
            assert callable(m.reader(x["name"]))
        for x in layer:
            assert x["moves"] in reported


def test_a_metric_added_as_files_is_picked_up(tmp_path):
    """A new per-layer metric is a new file and a new manifest entry: no
    file of the harness changes."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    d = _data()
    d["per_layer"].append({
        "name": "jobs.count", "unit": "jobs", "better": "higher",
        "source": "program_counter", "layer": "device",
        "moves": "api_reads_per_s", "workloads": ["ecoli2.blocks"]})
    with open(tmp_path / "BENCHMARK.json", "w") as fh:
        json.dump(d, fh)
    with open(tmp_path / "benchmark" / "metrics" / "jobs.count.py",
              "w") as fh:
        fh.write("def read(run):\n    return float(run.jobs)\n")
    m = Manifest(root=str(tmp_path), bench_dir=str(tmp_path / "benchmark"))
    names = [x["name"] for x in m.metrics_of("ecoli2.blocks", trace=True)]
    assert "jobs.count" in names
    assert "jobs.count" not in [x["name"] for x in
                                m.metrics_of("config4.cli", trace=True)]

    class Run:
        jobs = 7
    assert m.reader("jobs.count")(Run()) == 7.0


def test_a_cell_added_as_files_runs(tmp_path, monkeypatch):
    """A new configuration and cell are a new file and manifest entries;
    the harness runs the cell (here on the CPU, at a small size)."""
    import time

    import tempfile

    from harness import runner

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(BENCH, "configs", "config4.json")) as fh:
        cfg = json.load(fh)
    cfg["name"] = "tiny3"
    cfg["sim"].update(contig_len=30000, num_strains=3, num_snps=600)
    cfg["cli"] = {"pool": 1, "args": ["-p", "4"]}
    with open(tmp_path / "benchmark" / "configs" / "tiny3.json", "w") as fh:
        json.dump(cfg, fh)
    d = _data()
    d["configs"].append({"name": "tiny3", "source": "a test's community",
                         "file": "benchmark/configs/tiny3.json",
                         "reduced": [], "why": "a test"})
    d["workloads"].append({"name": "tiny3.cli", "config": "tiny3",
                           "traffic": "cli", "chips": 1, "why": "a test"})
    for m in d["end_to_end"]:
        if m["name"] == "cli_reads_per_s":
            m["workloads"].append("tiny3.cli")
    with open(tmp_path / "BENCHMARK.json", "w") as fh:
        json.dump(d, fh)
    m = Manifest(root=str(tmp_path), bench_dir=str(tmp_path / "benchmark"))
    res = runner.run_cell(m, "tiny3.cli", 12, 0.5, False, "cpu",
                          time.perf_counter())
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"cli_reads_per_s", "setup_s"}
