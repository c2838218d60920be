"""Benchmark of the port on a CUDA card: beam-search phasing throughput
against a measured single-core CPU baseline, plus an end-to-end metric
(the port of the repository's `bench.py`, with its keys and semantics).

    python -m floria_tpu_torch.bench [--quick] [--no-e2e] [--assert-floors]
                                     [--cache-dir DIR]
                                     [--measure-baseline-e2e]

Kernel metric (`value`): unique (read, block) insertions per second
through one mixed-ploidy beam dispatch (K1, `csrc/beam_scan.cu`): G
synthetic 3-strain blocks of R reads x S SNPs (`make_workload`), each
phased at ploidies 2..5 in the same dispatch, beam width 10, two allele
values, inputs already on the card; one warm call, then 3 calls (2 with
--quick), each ending in the pull of the scores. The real-shape run
(`make_workload(8, 320, 2048)`) is reported beside it.

vs_baseline: the denominator is measured in the same process by the
port's build of native/baseline.cpp (`native.baseline_sweep`): the
`faithful` variant, a single-core C++ port of the reference's inner loop
with its data structures, on a slice of the same workload; the dense
variant is reported too. They run on the card's host CPU, whose speed
moves them between machines.

e2e metric: bench.py's 2-strain E. coli community (`ecoli2`: 1 Mbp,
50,000 SNPs, 50x per strain, 11,111 phased reads) through the port's
whole pipeline (`pipeline.run`: ingest, realignment, sweep, join,
outputs), phased reads per second: the first run in the process, the
best of two warm repeats, and one fresh `python -m floria_tpu_torch.cli`
process. The simulated input is cached under --cache-dir
(`.bench_cache/torch/` by default). `e2e_vs_baseline` divides by the
single-core oracle pipeline (`floria_tpu_torch.oracle`, pinned to one
core by `scripts/oracle_e2e_baseline.py`) on the same community, as
recorded in the port's own record, floria_tpu_torch/BASELINE_E2E.json,
with the card line and CPU model of the host that measured it
(`baseline_e2e_source` names them). The measurement takes minutes, so
a run reads the record; --measure-baseline-e2e measures it again on
this host and writes it there, with the oracle's output texts held to
the port's run on the card. Without a record for the community there is
no e2e_vs_baseline: no other host's number stands in for it.

It measures on the card only: without one it raises, and no number of
a CPU run is printed under these keys. It keeps its own session bests
in `.bench_cache/torch/` and flags a kernel metric below half its best
or a stage over twice its best (--assert-floors exits 1 on the first);
the card has no committed floors yet (the repository's bench_floors.json
holds the TPU's, and is never read here). The one JSON line it prints
carries every key of bench.py's, and beside them `card` (nvidia-smi's
name and power limit), `device` and `baseline_e2e_source`.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from .device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(REPO, ".bench_cache", "torch")
# The e2e denominators measured on the card's host, by community tag.
RECORD = os.path.join(REPO, "floria_tpu_torch", "BASELINE_E2E.json")
PLOIDIES = (2, 3, 4, 5)
BEAM_WIDTH = 10
# The H100 SXM's HBM rate and its f32 rate outside the tensor cores
# (NVIDIA's data sheet); integer operations are counted at the f32 rate,
# which makes a bound from it a lower one.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

# The keys of a full run (no --quick, e2e on): bench.py's `result` keys,
# then the port's own three. A CPU test holds the first part to bench.py.
RESULT_KEYS = (
    "metric", "value", "unit", "vs_baseline",
    "baseline_cpu_faithful_reads_per_sec",
    "baseline_cpu_dense_reads_per_sec", "baseline_measured",
    "kernel_realshape_reads_per_sec", "kernel_realshape_config",
    "kernel_realshape_vs_baseline", "baseline_realshape_reads_per_sec",
    "e2e_reads_per_sec", "e2e_seconds", "e2e_cold_kind", "e2e_reads",
    "e2e_stages", "e2e_warm_reads_per_sec", "e2e_warm_seconds",
    "e2e_warm_stages", "e2e_vs_baseline", "baseline_e2e_reads_per_sec",
    "e2e_fresh_process_cold_seconds",
    "card", "device", "baseline_e2e_source")
# Present only when a session best fires.
REGRESSION_KEYS = ("kernel_regression", "stage_regressions")


def make_workload(G, R, S, num_strains=3, epsilon=0.02, seed=0):
    """bench.py's synthetic blocks: G instances of R reads, each read
    covering half of S sites of one of `num_strains` random haplotypes
    with `epsilon` errors, sorted by start. Returns (alleles int8 [G, R,
    S], weights f32, num_reads int32 [G], eps f32 [G])."""
    rng = np.random.default_rng(seed)
    strains = rng.integers(0, 2, (G, num_strains, S))
    origin = rng.integers(0, num_strains, (G, R))
    span = S // 2
    starts = rng.integers(0, S - span, (G, R))
    alleles = np.full((G, R, S), -1, dtype=np.int8)
    weights = np.zeros((G, R, S), dtype=np.float32)
    for g in range(G):
        for r in range(R):
            s0 = starts[g, r]
            hap = strains[g, origin[g, r], s0:s0 + span].copy()
            err = rng.random(span) < epsilon
            hap[err] = 1 - hap[err]
            alleles[g, r, s0:s0 + span] = hap
            weights[g, r, s0:s0 + span] = 1.0 - 10.0 ** (
                rng.integers(10, 40, span) / -10.0)
    order = np.argsort(starts, axis=1, kind="stable")
    alleles = np.take_along_axis(alleles, order[:, :, None], axis=1)
    weights = np.take_along_axis(weights, order[:, :, None], axis=1)
    num_reads = np.full(G, R, dtype=np.int32)
    eps = np.full(G, epsilon, dtype=np.float32)
    return alleles, weights, num_reads, eps


def nvidia_smi_line() -> str:
    """The card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the least time for `nbytes` of traffic and
    `ops` operations on the card."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def k1_cost(al, nr, npt, P, W):
    """(bytes, operations) of K1's bound on these inputs (alleles [G, R,
    S], num_reads [G], num_parts [G] tensors; dispatch ploidy P, beam
    width W): each real read's alleles (1 B) and weights (4 B) over its
    covered span read once; the records, scores, live flags and
    assignments written once; per (active part, covered column) of each
    read one comparison and one addition against one slot."""
    G, R, S = al.shape
    cov = al >= 0
    real = (torch.arange(R, device=al.device)[None, :]
            < nr.long()[:, None]) & cov.any(-1)
    first = torch.argmax(cov.to(torch.uint8), dim=-1)
    last = S - 1 - torch.argmax(cov.flip(-1).to(torch.uint8), dim=-1)
    span = int(torch.where(real, last - first + 1, 0).sum())
    ncov = (cov & real[..., None]).sum(dim=(1, 2)).long()
    T1 = min(25, R)
    rec = 1 if P * W <= 127 else 2
    Bf = W if R > T1 else P * W
    nbytes = (span * 5 + G * 24
              + G * (2 * T1 * P * W + 2 * (R - T1) * W + R) * rec
              + G * Bf * 9)
    return nbytes, 2 * int((ncov * npt.long()).sum())


def k1_bound(al, nr, npt, P, W):
    """K1's (bound_ms, bound_by) on these inputs (`k1_cost`)."""
    return bound(*k1_cost(al, nr, npt, P, W))


def kernel_inputs(args, device):
    """bench.py's mixed dispatch of `args` (make_workload's): every block
    once per ploidy of PLOIDIES, as tensors on `device` (alleles,
    weights, num_reads, eps, num_parts)."""
    dev = resolve_device(device)
    alleles, weights, num_reads, eps = args
    k = len(PLOIDIES)
    nparts = np.repeat(np.array(PLOIDIES, np.int32), len(alleles))
    return tuple(torch.from_numpy(np.concatenate([x] * k)).to(dev)
                 for x in (alleles, weights, num_reads, eps)) + (
        torch.from_numpy(nparts).to(dev),)


def kernel_dispatch(inputs, *, device):
    """The mixed dispatch `measure_kernel` times: K1 on a card (beam
    width 10, two allele values: the pipeline dispatches at the batch's
    allele width, biallelic here, as the C++ baseline runs)."""
    from .kernels import beam

    return beam.beam_search_batch_mixed(*inputs, max(PLOIDIES), BEAM_WIDTH,
                                        max_alleles=2, device=device)


def measure_kernel(args, quick, *, device):
    """Production-path sweep: ONE mixed-ploidy dispatch phases every
    block at ploidies 2..5 at once (what phase_instances dispatches per
    shape bucket), on inputs already on `device`. Returns G * R * iters /
    elapsed after one warm call; each call ends in the pull of the
    scores."""
    inputs = kernel_inputs(args, device)
    G, R, _S = args[0].shape
    iters = 2 if quick else 3

    def sweep():
        kernel_dispatch(inputs, device=device).scores.cpu()

    sweep()
    t0 = time.perf_counter()
    for _ in range(iters):
        sweep()
    return G * R * iters / (time.perf_counter() - t0)


def measure_cpu_baseline(args, quick):
    """Measured single-core denominators, (faithful, dense) reads/s: the
    port's native baseline on the first 2 (--quick) or 4 blocks of
    `args` at ploidies 2..5. A failed native build raises."""
    from . import native

    native.get_lib()  # a first call builds it: not the baseline's time
    alleles, weights, _nr, eps = args
    g_sub = 2 if quick else 4
    out = []
    for faithful in (True, False):
        t0 = time.perf_counter()
        n = native.baseline_sweep(alleles[:g_sub], weights[:g_sub],
                                  list(PLOIDIES), BEAM_WIDTH, float(eps[0]),
                                  faithful=faithful)
        out.append(n / (time.perf_counter() - t0))
    return out[0], out[1]


def measure_realshape_baseline(args):
    """The real-shape denominator: the faithful native baseline on the
    first block of `args` (bench.py's make_workload(8, 320, 2048)),
    reads/s."""
    from . import native

    native.get_lib()
    alleles, weights, _nr, eps = args
    t0 = time.perf_counter()
    n = native.baseline_sweep(alleles[:1], weights[:1], list(PLOIDIES),
                              BEAM_WIDTH, float(eps[0]), faithful=True)
    return n / (time.perf_counter() - t0)


def _e2e_config(quick):
    """(SimConfig, tag) of the e2e benchmark community (bench.py's)."""
    from .sim.simulate import SimConfig

    if quick:
        return SimConfig(contig_len=60_000, num_strains=2, num_snps=400,
                         coverage_per_strain=8.0, read_length=6_000,
                         read_length_sd=1_000.0, error_rate=0.02,
                         seed=11), "quick2"
    return SimConfig(contig_len=1_000_000, num_strains=2,
                     num_snps=50_000, coverage_per_strain=50.0,
                     read_length=9_000, read_length_sd=1_500.0,
                     error_rate=0.02, seed=11), "ecoli2"


def e2e_inputs(quick, cache=CACHE):
    """(SimConfig, directory) of the e2e community under `cache`,
    simulated there unless its BAM is there already."""
    from .sim.simulate import simulate

    cfg, tag = _e2e_config(quick)
    sim_dir = os.path.join(cache, tag)
    if not os.path.exists(os.path.join(sim_dir, "sim.bam")):
        simulate(cfg, sim_dir)
    return cfg, sim_dir


def _options(sim_dir, out_dir):
    from .options import Options

    return Options(bam_file=os.path.join(sim_dir, "sim.bam"),
                   vcf_file=os.path.join(sim_dir, "sim.vcf"),
                   reference_fasta=os.path.join(sim_dir, "sim.fa"),
                   out_dir=out_dir, overwrite=True)


def cpu_model() -> str:
    """This host's CPU: /proc/cpuinfo's `model name`, or where that says
    nothing (virtual machines may print "unknown") its vendor, family,
    model, stepping and clock; then the count of CPUs."""
    info = {}
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if not line.strip():
                    break  # the first processor's block only
                key, _, value = line.partition(":")
                info[key.strip()] = value.strip()
    except OSError:
        pass
    name = info.get("model name", "")
    if not name or name.lower() == "unknown":
        name = " ".join(f"{k} {info[k]}" for k in (
            "vendor_id", "cpu family", "model", "stepping", "cpu MHz")
            if info.get(k)) or platform.processor() or "unknown"
    return f"{name}, {os.cpu_count()} CPUs"


def recorded_baseline_e2e(quick, record=RECORD):
    """The single-core oracle-pipeline e2e entry of the community in the
    port's record (written by measure_baseline_e2e), or None."""
    _cfg, tag = _e2e_config(quick)
    if not os.path.exists(record):
        return None
    with open(record) as fh:
        return json.load(fh).get(tag)


def run_oracle_baseline(sim_dir, contig):
    """`python -m floria_tpu_torch.scripts.oracle_e2e_baseline` on the
    community in `sim_dir`, with no card visible (the oracle is a
    single-core CPU program and opens no context on the card). Returns
    (its JSON line, its ORACLE_CHILD report); raises if it fails or
    touched CUDA, jax or `floria_tpu`."""
    from .scripts import oracle_e2e_baseline as script

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "floria_tpu_torch.scripts.oracle_e2e_baseline",
         sim_dir, contig], env=env, cwd=REPO, capture_output=True,
        text=True, timeout=7200)
    if proc.returncode != 0:
        raise RuntimeError(f"oracle_e2e_baseline exited {proc.returncode}:"
                           f"\n{proc.stderr[-4000:]}")
    data = json.loads(proc.stdout.strip().splitlines()[-1])
    (report,) = [json.loads(ln[len(script.REPORT_PREFIX):])
                 for ln in proc.stderr.splitlines()
                 if ln.startswith(script.REPORT_PREFIX)]
    if report["cuda_initialized"] or report["loaded"]:
        raise RuntimeError(f"oracle_e2e_baseline touched CUDA or the JAX "
                           f"package: {report}")
    return data, report


def measure_baseline_e2e(quick, force=False, *, cache=CACHE, record=RECORD,
                         port_out=None):
    """Single-core oracle-pipeline e2e denominator (the kernel ratio
    alone excludes ingest and the join). The measurement is expensive
    (minutes on one core), so it persists in `record` (the port's
    committed floria_tpu_torch/BASELINE_E2E.json, keyed by community tag
    as bench.py's is) and normal runs only read it; with force=True it
    runs run_oracle_baseline on the community under `cache` and writes
    the tag's entry: the script's six keys, this host's nvidia-smi line
    (`card`) and CPU model (`cpu`), the child's peak resident bytes (in
    all and per stage) and `cuda_initialized` (False), and with `port_out` (the output
    directory of the port's run on the same inputs) `outputs_equal_to_port`,
    per text of oracle.pipeline.TEXT_FILES whether the oracle's equals
    the run's."""
    from .oracle.pipeline import read_texts

    cfg, tag = _e2e_config(quick)
    if not force:
        return recorded_baseline_e2e(quick, record)
    _cfg, sim_dir = e2e_inputs(quick, cache)
    data, report = run_oracle_baseline(sim_dir, cfg.contig_name)
    data.update(card=nvidia_smi_line(), cpu=cpu_model(),
                peak_host_bytes=report["peak_rss_bytes"],
                peak_host_bytes_by_stage=report["peak_rss_bytes_by_stage"],
                cuda_initialized=report["cuda_initialized"])
    if port_out is not None:
        oracle = read_texts(os.path.join(sim_dir, "oracle_out"),
                            cfg.contig_name)
        port = read_texts(port_out, cfg.contig_name)
        data["outputs_equal_to_port"] = {k: v is not None and v == port[k]
                                         for k, v in oracle.items()}
    rec = {}
    if os.path.exists(record):
        with open(record) as fh:
            rec = json.load(fh)
    rec[tag] = data
    with open(record, "w") as fh:
        json.dump(rec, fh, indent=1)
        fh.write("\n")
    return data


def baseline_e2e_source(record, entry, measured: bool) -> str:
    """Where e2e_vs_baseline's denominator comes from: the record, the
    card line and CPU of the host that measured it, and whether this run
    measured it."""
    return (f"{os.path.relpath(record, REPO)}: the oracle pipeline pinned "
            f"to one core on the host of {entry['card']} "
            f"(CPU {entry['cpu']}); "
            + ("measured in this run" if measured
               else "recorded by an earlier --measure-baseline-e2e run"))


def measure_e2e(quick, repeat=False, *, device, cache=CACHE):
    """Full-pipeline reads/s on the `ecoli2` community (`quick2` under
    --quick) on `device`. Returns [(reads_per_sec, seconds, n_reads,
    stages)]: the first run in this process, and with repeat=True also
    the best of two warm repeats (the steady state of a long-lived
    process; host stages swing run to run, and the steady-state number
    should reflect the pipeline, not a bad draw). n_reads counts the
    haploset members of the first run."""
    from . import timing
    from .pipeline import run

    dev = resolve_device(device)
    cfg, sim_dir = e2e_inputs(quick, cache)
    out_dir = os.path.join(sim_dir, "out")

    def once():
        shutil.rmtree(out_dir, ignore_errors=True)
        t0 = time.perf_counter()
        run(_options(sim_dir, out_dir), device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        elapsed = time.perf_counter() - t0
        return elapsed, {k: round(v, 1)
                         for k, v in timing.STAGE_TIMES.items()}

    elapsed, stages = once()
    n_reads = 0
    hs = os.path.join(out_dir, cfg.contig_name,
                      f"{cfg.contig_name}.haplosets")
    if os.path.exists(hs):
        with open(hs) as fh:
            n_reads = sum(1 for line in fh if not line.startswith(">"))
    out = [(n_reads / elapsed, elapsed, n_reads, stages)]
    if repeat:
        best = None
        for _ in range(2):
            elapsed, stages = once()
            if best is None or elapsed < best[1]:
                best = (n_reads / elapsed, elapsed, n_reads, stages)
        out.append(best)
    return out


def measure_fresh_process_cold(opts, *, device):
    """Fresh-process cold e2e: wall seconds of one `python -m
    floria_tpu_torch.cli` subprocess on `device` with the kernels built:
    what every new rank or job pays (interpreter and torch start-up, the
    card's context, loading the kernel library), against e2e_seconds'
    in-process first run. None, with its error on stderr, if it fails."""
    out_dir = opts.out_dir + "_freshcold"
    shutil.rmtree(out_dir, ignore_errors=True)
    cmd = [sys.executable, "-m", "floria_tpu_torch.cli",
           "-b", opts.bam_file, "-v", opts.vcf_file,
           "-r", opts.reference_fasta, "-o", out_dir, "--overwrite",
           "--device", str(device)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                          timeout=3600)
    elapsed = time.perf_counter() - t0
    shutil.rmtree(out_dir, ignore_errors=True)
    if proc.returncode != 0:
        print(f"fresh-process cold run failed ({proc.returncode}):\n"
              f"{proc.stderr[-4000:]}", file=sys.stderr)
        return None
    return elapsed


def kernels_built() -> bool:
    """Whether the CUDA kernel library (kernels/_build.py's LIB_PATH) is
    there and newer than its sources: no nvcc build at first use."""
    from .kernels import _build

    return not _build._stale(_build.LIB_PATH)


def e2e_cold_kind(built_at_start: bool) -> str:
    """The port's label for e2e_seconds (bench.py's XLA-cache label):
    whether this process had to build the kernels with nvcc. The build
    lands in the kernel metric's warm call, before the e2e runs."""
    return ("in-process-first-run-warm-build" if built_at_start
            else "first-contact-nvcc-build")


def _check_kernel_floor(result, best_path=None):
    """Flag a kernel metric (`value`, `kernel_realshape_reads_per_sec`)
    below half its session best (.bench_cache/torch/kernel_best.json,
    per machine; bests only improve): the result gets
    `kernel_regression` and stderr a KERNEL REGRESSION line. Returns
    True when one fired (main() exits 1 under --assert-floors)."""
    if best_path is None:
        best_path = os.path.join(CACHE, "kernel_best.json")
    best = {}
    if os.path.exists(best_path):
        with open(best_path) as fh:
            best = json.load(fh)
    regressions = {}
    for k in ("value", "kernel_realshape_reads_per_sec"):
        v = result.get(k)
        if v is None:
            continue
        b = best.get(k)
        if b is not None and v < 0.5 * b:
            regressions[k] = {"reads_per_sec": v, "recorded_best": b}
        if b is None or v > b:
            best[k] = v
    os.makedirs(os.path.dirname(best_path), exist_ok=True)
    with open(best_path, "w") as fh:
        json.dump(best, fh)
    if regressions:
        result["kernel_regression"] = regressions
        print(f"KERNEL REGRESSION: {json.dumps(regressions)}",
              file=sys.stderr)
        return True
    return False


def _check_stage_regressions(result, path=None):
    """Flag a warm stage over twice its session best
    (.bench_cache/torch/stage_best.json; bests only improve, stages under
    0.3 s are never flagged) as `stage_regressions`."""
    stages = result.get("e2e_warm_stages") or result.get("e2e_stages")
    if not stages:
        return
    if path is None:
        path = os.path.join(CACHE, "stage_best.json")
    best = {}
    if os.path.exists(path):
        with open(path) as fh:
            best = json.load(fh)
    regressions = {}
    for k, v in stages.items():
        b = best.get(k)
        if b is not None and b >= 0.3 and v > 2.0 * b:
            regressions[k] = {"seconds": v, "recorded_best": b}
        if b is None or v < b:
            best[k] = v
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(best, fh)
    if regressions:
        result["stage_regressions"] = regressions


def collect(quick, skip_e2e, *, device, cache=CACHE, built_at_start=True,
            measure_baseline=False, record=RECORD):
    """Every measurement of one bench run on `device`, as the result
    dict (without the session-best checks). main() calls it on the card
    only. With measure_baseline the e2e denominator is measured on this
    host into `record` (measure_baseline_e2e), else read from it."""
    dev = resolve_device(device)
    G, R, S = (8, 64, 128) if quick else (32, 256, 256)
    args = make_workload(G, R, S)
    kernel_rps = measure_kernel(args, quick, device=dev)
    # Real-block-shape run: e2e blocks bucket at R~320, S~1536-2048,
    # where a step costs several times the S=256 config's.
    real_rps = real_base = None
    if not quick:
        real_args = make_workload(8, 320, 2048)
        real_rps = measure_kernel(real_args, quick, device=dev)
        real_base = measure_realshape_baseline(real_args)
    base_faithful, base_dense = measure_cpu_baseline(args, quick)

    result = {
        "metric": "reads_per_sec_per_chip",
        "value": round(kernel_rps, 1),
        "unit": "reads/s (full 2..5 ploidy sweep, beam 10)",
        "vs_baseline": round(kernel_rps / base_faithful, 2),
        "baseline_cpu_faithful_reads_per_sec": round(base_faithful, 1),
        "baseline_cpu_dense_reads_per_sec": round(base_dense, 1),
        "baseline_measured": True,
    }
    if real_rps is not None:
        result["kernel_realshape_reads_per_sec"] = round(real_rps, 1)
        result["kernel_realshape_config"] = "G=8 R=320 S=2048"
        result["kernel_realshape_vs_baseline"] = round(real_rps / real_base,
                                                       2)
        result["baseline_realshape_reads_per_sec"] = round(real_base, 1)
    if not skip_e2e:
        runs = measure_e2e(quick, repeat=not quick, device=dev, cache=cache)
        e2e_rps, e2e_s, e2e_reads, e2e_stages = runs[0]
        result["e2e_reads_per_sec"] = round(e2e_rps, 1)
        result["e2e_seconds"] = round(e2e_s, 1)
        result["e2e_cold_kind"] = e2e_cold_kind(built_at_start)
        result["e2e_reads"] = e2e_reads
        result["e2e_stages"] = e2e_stages
        if len(runs) > 1:
            w_rps, w_s, _, w_stages = runs[1]
            result["e2e_warm_reads_per_sec"] = round(w_rps, 1)
            result["e2e_warm_seconds"] = round(w_s, 1)
            result["e2e_warm_stages"] = w_stages
        _cfg, sim_dir = e2e_inputs(quick, cache)
        base_e2e = measure_baseline_e2e(
            quick, force=measure_baseline, cache=cache, record=record,
            port_out=os.path.join(sim_dir, "out"))
        if base_e2e:
            denom_e2e = base_e2e["baseline_e2e_reads_per_sec"]
            best_rps = (result.get("e2e_warm_reads_per_sec")
                        or result["e2e_reads_per_sec"])
            result["e2e_vs_baseline"] = round(best_rps / denom_e2e, 2)
            result["baseline_e2e_reads_per_sec"] = round(denom_e2e, 1)
            result["baseline_e2e_source"] = baseline_e2e_source(
                record, base_e2e, measure_baseline)
        if not quick:
            fresh = measure_fresh_process_cold(
                _options(sim_dir, os.path.join(sim_dir, "out")), device=dev)
            if fresh is not None:
                result["e2e_fresh_process_cold_seconds"] = round(fresh, 1)
    if dev.type == "cuda":
        result["card"] = nvidia_smi_line()
        result["device"] = {"name": torch.cuda.get_device_name(dev),
                            "count": torch.cuda.device_count()}
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m floria_tpu_torch.bench",
        description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="small kernel workload and the quick2 community")
    ap.add_argument("--no-e2e", action="store_true",
                    help="the kernel metric and its denominators only")
    ap.add_argument("--assert-floors", action="store_true",
                    help="exit 1 when a kernel metric is below half its "
                    "session best")
    ap.add_argument("--cache-dir", default=CACHE,
                    help="where the simulated e2e communities are kept "
                    "(default: .bench_cache/torch/ in the checkout)")
    ap.add_argument("--measure-baseline-e2e", action="store_true",
                    help="measure the single-core oracle-pipeline e2e "
                    "denominator on this host (minutes) and write it to "
                    "floria_tpu_torch/BASELINE_E2E.json, instead of reading "
                    "it there")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("floria_tpu_torch.bench measures on a CUDA card "
                           "and torch.cuda.is_available() is False")
    # Before any device work: the kernel metric's warm call builds them.
    built = kernels_built()
    result = collect(args.quick, args.no_e2e, device="cuda",
                     cache=args.cache_dir, built_at_start=built,
                     measure_baseline=args.measure_baseline_e2e)
    regressed = False
    if not args.quick:
        # Quick-config numbers would poison the session bests.
        if not args.no_e2e:
            _check_stage_regressions(result)
        regressed = _check_kernel_floor(result)
    print(json.dumps(result), flush=True)
    if regressed and args.assert_floors:
        sys.exit(1)


if __name__ == "__main__":
    main()
