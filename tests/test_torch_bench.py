"""The port's benchmark entry point and its measurement scripts
(`floria_tpu_torch.bench`, `floria_tpu_torch.scripts.{multihost_bench,
mfu, scaling_bench, profile_beam}`) on the CPU, against bench.py and the
JAX scripts: the same workload, the same dispatch bitwise on JAX's CPU
backend, the same e2e read count and output bytes as the JAX pipeline on
`quick2`, every key of bench.py's result, bench.py's guard cases on the
port's session-best files (bench_floors.json, the TPU's floors, never
read), and the scripts at a tiny size on `--device cpu`. Measurements on
the card are chip_smoke.py's `bench` phase.

Run as a script, it writes tests/data/bench_golden.json: the JAX
pipeline on bench.py's `quick2` community (its inputs' sha256, the
phased read count bench.py's `measure_e2e` takes, and every output
file's sha256 with the output directory written as `<out>`):

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_bench.py
"""

import ast
import builtins
import json
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

import bench as jax_bench
import chip_smoke
from floria_tpu_torch import bench
from floria_tpu_torch.kernels import beam as TB
from floria_tpu_torch.scripts import mfu, multihost_bench, profile_beam, \
    scaling_bench

# One intra-op thread: the suite runs several pytest workers on one
# host, and oversubscribed OpenMP threads slow every worker down.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "bench_golden.json")
INPUTS = ("sim.bam", "sim.vcf", "sim.fa")


@pytest.mark.parametrize("shape", [(3, 40, 256, 4), (2, 24, 64, 0),
                                   (5, 17, 33, 9)])
def test_make_workload_matches_bench_py(shape):
    G, R, S, seed = shape
    for got, want in zip(bench.make_workload(G, R, S, seed=seed),
                         jax_bench.make_workload(G, R, S, seed=seed)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_kernel_dispatch_matches_jax_mixed_beam():
    """The dispatch measure_kernel times (every block at ploidies 2..5
    in one mixed dispatch, beam width 10, two alleles), plain path on
    the CPU, against JAX's beam_search_batch_mixed on its CPU backend:
    records, scores, live flags and traceback assignments bitwise."""
    from floria_tpu.kernels import beam as B

    args = bench.make_workload(2, 24, 64)
    inputs = bench.kernel_inputs(args, "cpu")
    assert [int(p) for p in inputs[4]] == [2, 2, 3, 3, 4, 4, 5, 5]
    got = bench.kernel_dispatch(inputs, device="cpu")
    k = len(bench.PLOIDIES)
    want = B.beam_search_batch_mixed(
        *(np.concatenate([x] * k) for x in args), inputs[4].numpy(),
        max(bench.PLOIDIES), bench.BEAM_WIDTH, max_alleles=2)
    for name, a, b in zip(got._fields, want, got):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype, name
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
    np.testing.assert_array_equal(np.asarray(B.traceback_batch(tuple(want))),
                                  TB.traceback_batch(got).numpy())
    assert bench.measure_kernel(args, True, device="cpu") > 0


def _output_hashes(out_dir):
    return chip_smoke.output_sha256(out_dir, out_dir)


def test_measure_e2e_quick_matches_jax_pipeline(tmp_path):
    """measure_e2e on quick2 with the plain path: the simulated inputs,
    the phased read count and every output file equal to the JAX
    pipeline's (tests/data/bench_golden.json)."""
    with open(GOLDEN) as fh:
        want = json.load(fh)["quick2"]
    runs = bench.measure_e2e(True, repeat=False, device="cpu",
                             cache=str(tmp_path))
    assert len(runs) == 1
    rps, seconds, n_reads, stages = runs[0]
    assert n_reads == want["e2e_reads"] > 0
    assert rps == n_reads / seconds and "phasing" in stages
    sim_dir = tmp_path / "quick2"
    assert {f: chip_smoke._sha256(str(sim_dir / f)) for f in INPUTS} \
        == want["inputs_sha256"]
    assert _output_hashes(str(sim_dir / "out")) == want["outputs_sha256"]


# The six keys of the oracle e2e script's line (scripts/
# oracle_e2e_baseline.py's and the port's).
BASELINE_ENTRY = {"baseline_e2e_reads_per_sec": 84.6,
                  "baseline_e2e_seconds": 131.3, "baseline_e2e_reads": 11111,
                  "baseline_e2e_ingest_seconds": 32.3,
                  "baseline_e2e_phase_seconds": 92.7,
                  "pinned_single_core": True}


def _bench_py_result_keys():
    """Every key bench.py puts in its result: the `result = {...}`
    literal's and every `result["..."]` subscript, in any function."""
    with open(os.path.join(REPO, "bench.py")) as fh:
        tree = ast.parse(fh.read())
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "result"
                        for t in node.targets)):
            keys |= {k.value for k in node.value.keys}
        elif (isinstance(node, ast.Subscript)
              and isinstance(node.value, ast.Name)
              and node.value.id == "result"
              and isinstance(node.slice, ast.Constant)):
            keys.add(node.slice.value)
    return keys


def test_result_keys_are_bench_py_keys_and_the_card():
    jax_keys = _bench_py_result_keys()
    assert len(jax_keys) == 24
    ours = set(bench.RESULT_KEYS) | set(bench.REGRESSION_KEYS)
    assert jax_keys <= ours
    assert ours - jax_keys == {"card", "device", "baseline_e2e_source"}


def test_collect_fills_every_key(tmp_path, monkeypatch):
    """A full run's result (measurements stubbed: their numbers come
    only from a card) holds every key of RESULT_KEYS; `card` and
    `device` are written only on a card."""
    cfg, _tag = bench._e2e_config(False)
    monkeypatch.setattr(bench, "measure_kernel",
                        lambda args, quick, *, device: 1000.0)
    monkeypatch.setattr(bench, "measure_realshape_baseline", lambda a: 8.0)
    monkeypatch.setattr(bench, "measure_cpu_baseline",
                        lambda args, quick: (10.0, 40.0))
    monkeypatch.setattr(bench, "e2e_inputs",
                        lambda quick, cache: (cfg, str(tmp_path)))
    monkeypatch.setattr(
        bench, "measure_e2e", lambda quick, repeat, *, device, cache: [
            (100.0, 2.0, 200, {"phasing": 1.0}),
            (200.0, 1.0, 200, {"phasing": 0.5})])
    monkeypatch.setattr(bench, "measure_fresh_process_cold",
                        lambda opts, *, device: 3.0)
    record = tmp_path / "record.json"
    record.write_text(json.dumps({"ecoli2": dict(
        BASELINE_ENTRY, card="NVIDIA H100 80GB HBM3, 700.00 W",
        cpu="Some CPU")}))
    result = bench.collect(False, False, device="cpu", cache=str(tmp_path),
                           built_at_start=False, record=str(record))
    assert set(bench.RESULT_KEYS) - set(result) == {"card", "device"}
    assert result["vs_baseline"] == 100.0
    assert result["e2e_cold_kind"] == "first-contact-nvcc-build"
    assert result["e2e_vs_baseline"] == round(200.0 / 84.6, 2)
    assert result["baseline_e2e_reads_per_sec"] == 84.6
    assert result["e2e_warm_seconds"] == 1.0
    source = result["baseline_e2e_source"]
    assert os.path.relpath(str(record), REPO) in source
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in source
    assert "Some CPU" in source and "earlier" in source


def _stub_collect_inputs(monkeypatch, tmp_path, quick):
    """collect's measurements stubbed (their numbers come only from a
    card), its e2e community under tmp_path."""
    cfg, tag = bench._e2e_config(quick)
    monkeypatch.setattr(bench, "measure_kernel",
                        lambda args, quick, *, device: 1000.0)
    monkeypatch.setattr(bench, "measure_realshape_baseline", lambda a: 8.0)
    monkeypatch.setattr(bench, "measure_cpu_baseline",
                        lambda args, quick: (10.0, 40.0))
    monkeypatch.setattr(bench, "e2e_inputs",
                        lambda quick, cache: (cfg, str(tmp_path / tag)))
    monkeypatch.setattr(
        bench, "measure_e2e", lambda quick, repeat, *, device, cache: [
            (100.0, 2.0, 200, {"phasing": 1.0})])
    monkeypatch.setattr(bench, "measure_fresh_process_cold",
                        lambda opts, *, device: 3.0)
    return cfg, tag


def test_without_a_record_there_is_no_e2e_vs_baseline(tmp_path,
                                                      monkeypatch):
    """No entry for the community in the record: the result has no
    e2e_vs_baseline and no denominator, and no other host's number
    stands in."""
    _stub_collect_inputs(monkeypatch, tmp_path, True)
    for record in (tmp_path / "none.json", tmp_path / "other.json"):
        if record.name == "other.json":
            record.write_text(json.dumps({"ecoli2": BASELINE_ENTRY}))
        result = bench.collect(True, False, device="cpu",
                               cache=str(tmp_path), record=str(record))
        assert result["e2e_reads_per_sec"] == 100.0
        assert not {"e2e_vs_baseline", "baseline_e2e_reads_per_sec",
                    "baseline_e2e_source"} & set(result)


def _sha256(path):
    return chip_smoke._sha256(path) if os.path.exists(path) else None


def test_measure_baseline_e2e_writes_only_its_record(tmp_path, monkeypatch):
    """With the subprocess stubbed, measure_baseline_e2e writes the tag's
    entry (the six keys, the card line, the CPU, the child's figures and
    the comparison with the port's run) into the record it is given,
    keeps the record's other tags, and leaves BASELINE_E2E.json and the
    port's committed record as they were."""
    from floria_tpu_torch.oracle import pipeline as oracle_pipeline

    protected = [os.path.join(REPO, "BASELINE_E2E.json"), bench.RECORD]
    before = [_sha256(p) for p in protected]
    cfg, tag = _stub_collect_inputs(monkeypatch, tmp_path, True)
    sim_dir = str(tmp_path / tag)
    texts = {"vartigs": f">HAP0.{oracle_pipeline.CDIR}\n0\n",
             "haplosets": f">HAP0.{oracle_pipeline.CDIR}\nr\t1\t1\n",
             "info": "", "ploidy": f"{cfg.contig_name}\t1.000\n"}
    oracle_pipeline.write_texts(texts, os.path.join(sim_dir, "oracle_out"),
                                cfg.contig_name)
    port_out = str(tmp_path / "port_out")
    oracle_pipeline.write_texts(dict(texts, info="x"), port_out,
                                cfg.contig_name)
    calls = []
    monkeypatch.setattr(bench, "run_oracle_baseline", lambda d, c: (
        calls.append((d, c)) or (dict(BASELINE_ENTRY), {
            "cuda_initialized": False, "loaded": [],
            "peak_rss_bytes": 1 << 20,
            "peak_rss_bytes_by_stage": {"ingest": 1 << 19}})))
    monkeypatch.setattr(bench, "nvidia_smi_line",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    record = tmp_path / "record.json"
    record.write_text(json.dumps({"ecoli2": {"kept": 1}}))
    entry = bench.measure_baseline_e2e(True, force=True, cache=str(tmp_path),
                                       record=str(record), port_out=port_out)
    assert calls == [(sim_dir, cfg.contig_name)]
    assert entry == dict(
        BASELINE_ENTRY, card="NVIDIA H100 80GB HBM3, 700.00 W",
        cpu=bench.cpu_model(), peak_host_bytes=1 << 20,
        peak_host_bytes_by_stage={"ingest": 1 << 19},
        cuda_initialized=False, outputs_equal_to_port={
            "vartigs": True, "haplosets": True, "info": False,
            "ploidy": True})
    assert json.loads(record.read_text()) == {"ecoli2": {"kept": 1},
                                              tag: entry}
    assert bench.measure_baseline_e2e(True, record=str(record)) == entry
    assert [_sha256(p) for p in protected] == before


def test_recorded_baseline_e2e_reads_the_ports_record(monkeypatch):
    """recorded_baseline_e2e opens the port's record, never the root
    BASELINE_E2E.json, and the committed record's `ecoli2` entry was
    measured on a card's host."""
    assert bench.RECORD == os.path.join(REPO, "floria_tpu_torch",
                                        "BASELINE_E2E.json")
    opened = []
    real_open = builtins.open

    def spy(path, *a, **kw):
        opened.append(os.path.abspath(str(path)))
        return real_open(path, *a, **kw)

    monkeypatch.setattr(builtins, "open", spy)
    entry = bench.recorded_baseline_e2e(False)
    assert opened == [bench.RECORD]
    assert set(BASELINE_ENTRY) <= set(entry)
    assert entry["card"].startswith("NVIDIA") and entry["cpu"]
    assert entry["cuda_initialized"] is False
    assert bench.recorded_baseline_e2e(True) is None


@pytest.mark.parametrize("flag", [[], ["--measure-baseline-e2e"]])
def test_measure_baseline_e2e_flag_parses(flag, monkeypatch, capsys):
    """--measure-baseline-e2e reaches collect as measure_baseline=True
    (the measurement forced, as bench.py forces it)."""
    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench, "kernels_built", lambda: True)
    monkeypatch.setattr(bench, "collect", lambda quick, skip_e2e, **kw: (
        seen.append(kw) or {"value": 1.0}))
    bench.main(["--quick", *flag])
    assert [kw["measure_baseline"] for kw in seen] == [bool(flag)]
    assert json.loads(capsys.readouterr().out) == {"value": 1.0}


def test_oracle_e2e_baseline_script_on_a_tiny_contig(tmp_path):
    """The real script (`python -m floria_tpu_torch.scripts.
    oracle_e2e_baseline`, one core, no card visible) on a tiny simulated
    contig: its line holds the six keys, its process loaded neither jax
    nor `floria_tpu` and initialised no CUDA, and its texts equal the
    port's pipeline.run with the same Options."""
    from floria_tpu_torch.oracle.pipeline import read_texts
    from floria_tpu_torch.pipeline import run
    from floria_tpu_torch.sim.simulate import SimConfig, simulate

    cfg = SimConfig(contig_len=20_000, num_strains=2, num_snps=100,
                    coverage_per_strain=8.0, read_length=3_000,
                    read_length_sd=400.0, error_rate=0.01, seed=7)
    sim_dir = str(tmp_path)
    simulate(cfg, sim_dir)
    data, report = bench.run_oracle_baseline(sim_dir, cfg.contig_name)
    assert set(data) == set(BASELINE_ENTRY)
    assert data["pinned_single_core"] is True
    assert data["baseline_e2e_reads"] > 0
    assert data["baseline_e2e_reads_per_sec"] == pytest.approx(
        data["baseline_e2e_reads"] / data["baseline_e2e_seconds"])
    assert report["loaded"] == [] and report["cuda_initialized"] is False
    assert report["peak_rss_bytes"] > 50 << 20
    assert sorted(report["peak_rss_bytes_by_stage"]) == ["ingest", "phase",
                                                          "texts"]
    assert max(v for v in report["peak_rss_bytes_by_stage"].values()
               if v is not None) <= report["peak_rss_bytes"]
    out_dir = str(tmp_path / "out")
    run(bench._options(sim_dir, out_dir), device="cpu")
    texts = read_texts(str(tmp_path / "oracle_out"), cfg.contig_name)
    assert all(texts.values())
    assert texts == read_texts(out_dir, cfg.contig_name)


@pytest.mark.parametrize("module", [
    bench, mfu, scaling_bench, profile_beam, multihost_bench])
def test_entry_points_raise_without_a_card(module, tmp_path):
    """With no argument each entry point measures on `cuda`; without a
    card it raises before it measures anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = (["--base", str(tmp_path / "none")]
            if module is multihost_bench else [])
    with pytest.raises(RuntimeError, match="is_available"):
        module.main(argv)
    assert not (tmp_path / "none").exists()


def _best_path(tmp_path):
    return str(tmp_path / "cache" / "kernel_best.json")


def test_session_best_fires(tmp_path, capsys):
    best_path = _best_path(tmp_path)
    os.makedirs(os.path.dirname(best_path))
    with open(best_path, "w") as fh:
        json.dump({"value": 90000.0,
                   "kernel_realshape_reads_per_sec": 15000.0}, fh)
    result = {"value": 35000.0, "kernel_realshape_reads_per_sec": 5100.0}
    assert bench._check_kernel_floor(result, best_path)
    assert result["kernel_regression"]["value"]["recorded_best"] == 90000.0
    assert "KERNEL REGRESSION" in capsys.readouterr().err


def test_session_best_halving_fires_and_best_only_improves(tmp_path):
    best_path = _best_path(tmp_path)
    ok = {"value": 100000.0}
    assert not bench._check_kernel_floor(ok, best_path)
    with open(best_path) as fh:
        assert json.load(fh)["value"] == 100000.0
    dip = {"value": 80000.0}
    assert not bench._check_kernel_floor(dip, best_path)
    with open(best_path) as fh:
        assert json.load(fh)["value"] == 100000.0
    bad = {"value": 40000.0}
    assert bench._check_kernel_floor(bad, best_path)
    assert bad["kernel_regression"]["value"]["recorded_best"] == 100000.0


def test_quiet_when_healthy(tmp_path):
    best_path = _best_path(tmp_path)
    assert not bench._check_kernel_floor({"value": 90000.0}, best_path)
    result = {"value": 95000.0}
    assert not bench._check_kernel_floor(result, best_path)
    assert "kernel_regression" not in result


def test_bench_floors_json_is_never_read(tmp_path, monkeypatch):
    """Below the repository's committed TPU floors and with no session
    best, nothing fires, and neither guard opens bench_floors.json; the
    stage guard works on its own session-best file."""
    with open(os.path.join(REPO, "bench_floors.json")) as fh:
        floors = json.load(fh)
    opened = []
    real_open = builtins.open

    def spy(path, *a, **kw):
        opened.append(os.path.basename(str(path)))
        return real_open(path, *a, **kw)

    monkeypatch.setattr(builtins, "open", spy)
    monkeypatch.setattr(bench, "CACHE", str(tmp_path / "cache"))
    monkeypatch.chdir(REPO)
    result = {k: v / 2 for k, v in floors.items() if k != "_comment"}
    assert not bench._check_kernel_floor(result)
    stages = {"e2e_warm_stages": {"phasing": 1.0, "join_outputs": 0.5}}
    bench._check_stage_regressions(stages)
    slow = {"e2e_warm_stages": {"phasing": 2.5, "join_outputs": 0.5}}
    bench._check_stage_regressions(slow)
    assert slow["stage_regressions"] == {
        "phasing": {"seconds": 2.5, "recorded_best": 1.0}}
    assert "kernel_regression" not in result
    assert sorted(set(opened)) == ["kernel_best.json", "stage_best.json"]


def test_multihost_bench_two_ranks_match_one_process(tmp_path):
    """Three contigs of config #5, one process and two ranks on the CPU,
    unpinned: every .vartigs and .haplosets equal, the summary written
    to --json (never MULTIHOST_BENCH.json)."""
    record = os.path.join(REPO, "MULTIHOST_BENCH.json")
    before = os.stat(record).st_mtime_ns
    out = tmp_path / "summary.json"
    summary = multihost_bench.main([
        "--contigs", "3", "--procs", "1,2", "--no-pin", "--device", "cpu",
        "--base", str(tmp_path / "meta3"), "--json", str(out)])
    one, two = summary["results"][1], summary["results"][2]
    assert two["outputs_match_1proc"] == 6
    assert one["reads"] == two["reads"] > 0
    assert summary["device"] == "cpu" and summary["card"] is None
    with open(out) as fh:
        assert json.load(fh)["results"]["2"]["reads"] == two["reads"]
    assert os.stat(record).st_mtime_ns == before


def test_scaling_bench_on_cpu_shards():
    rows = scaling_bench.measure(4, 16, 32, [1, 2], device="cpu")
    assert [r["shards"] for r in rows] == [1, 2]
    assert rows[0]["efficiency"] == 1.0
    assert all(r["device"] == "cpu" and r["blocks_per_sec"] > 0
               and "card" not in r for r in rows)
    assert scaling_bench.shard_mesh(3, torch.device("cpu")) == \
        [torch.device("cpu")] * 3


def test_profile_beam_points_on_cpu():
    rows = [profile_beam.run_case(4, 16, 32, 0, device="cpu"),
            profile_beam.run_case(4, 16, 512, 384, dedup=False,
                                  device="cpu")]
    assert profile_beam._point("4,512,384,nodedup") == (4, 512, 384, False)
    assert profile_beam._point("32,256,0") == (32, 256, 0, True)
    assert [(r["G"], r["S"], r["window"], r["dedup"]) for r in rows] == [
        (4, 32, 0, True), (4, 512, 384, False)]
    assert all(r["ms_per_step"] * 16 == pytest.approx(r["ms_per_sweep"])
               for r in rows)
    # The default grid's windows hold make_workload's reads (S/2 long),
    # so K1 takes them.
    for _G, S, window, _dedup in profile_beam.GRID:
        assert window == 0 or S > window >= S // 2 + 128


def test_mfu_counts_on_a_hand_worked_shape():
    """One block of 27 reads, each covering 4 of 8 columns, at P = 2,
    W = 10 (T1 = 25). Work: 25 warm steps of B = 20 slots in and out
    (2*40*4 scoring + 7*40 prune and dedup + 40*5 select + 20*4 update
    = 880 each), the step to W (320 + 280 + 40*4 + 40 = 800) and one
    main step of B = 10 (160 + 140 + 20*4 + 40 = 420): 23,220. Bound:
    2 operations per (part, covered column) against one slot: 2 * 27 *
    4 * 2 = 432; bytes: 27 reads * 4 columns * 5 B + 24 + records
    (2*25*20 + 2*2*10 + 27) + 10 slots * 9 B = 1,721."""
    al = torch.full((1, 27, 8), -1, dtype=torch.int8)
    al[:, :, 2:6] = 0
    nr, npt = torch.tensor([27]), torch.tensor([2])
    assert mfu.step_ops(20, 2, 4, 20) == 880
    assert mfu.k1_work(al, nr, npt, 10) == 23_220
    assert bench.k1_cost(al, nr, npt, 2, 10) == (1_721, 432)
    # Reads past num_reads do no work.
    assert mfu.k1_work(al, torch.tensor([25]), npt, 10) == 25 * 880
    rows = mfu.model_table()
    assert [(r["R"], r["S"]) for r in rows] == [(256, 256), (320, 2048)]
    assert all(r["sweep_work_gops_per_block"]
               > r["sweep_bound_gops_per_block"] for r in rows)


def write_golden():
    """The JAX pipeline on bench.py's quick2 community: its inputs'
    sha256, bench.py's read count (haploset members) and its outputs'
    sha256 (cmd.log left out, the output directory as `<out>`)."""
    from floria_tpu.options import Options
    from floria_tpu.pipeline import run
    from floria_tpu.sim.simulate import simulate

    cfg, tag = jax_bench._e2e_config(True)
    with tempfile.TemporaryDirectory() as tmp:
        sim_dir = os.path.join(tmp, tag)
        simulate(cfg, sim_dir)
        out_dir = os.path.join(sim_dir, "out")
        run(Options(bam_file=os.path.join(sim_dir, "sim.bam"),
                    vcf_file=os.path.join(sim_dir, "sim.vcf"),
                    reference_fasta=os.path.join(sim_dir, "sim.fa"),
                    out_dir=out_dir, overwrite=True))
        hs = os.path.join(out_dir, cfg.contig_name,
                          f"{cfg.contig_name}.haplosets")
        with open(hs) as fh:
            n_reads = sum(1 for line in fh if not line.startswith(">"))
        record = {tag: {
            "inputs_sha256": {f: chip_smoke._sha256(os.path.join(sim_dir, f))
                              for f in INPUTS},
            "e2e_reads": n_reads,
            "outputs_sha256": _output_hashes(out_dir)}}
    with open(GOLDEN, "w") as fh:
        json.dump(record, fh, indent=1)
        fh.write("\n")
    print(f"wrote {GOLDEN}", file=sys.stderr)


if __name__ == "__main__":
    write_golden()
