"""Multi-process scaling benchmark of the port: BASELINE.json config #5
(a 500-contig metagenome) phased by 1, 2 and 4 processes of the port
(`parallel/multihost.py` `run_multihost`: contigs sharded over ranks, a
TCPStore barrier, rank 0 merging the summary TSVs), wall-clocked, with
scaling efficiency (the port of scripts/multihost_bench.py).

Every rank runs on `--device` (cuda by default: the ranks split the
host's cards, parallel/multihost.py `rank_cards`, and share them where
there are fewer cards than ranks; cpu for tests). Host stages
(ingest, join, outputs) dominate a rank's time and are what this axis
scales.

Two modes:
  * pinned (default): each process bound to its own core by taskset, so
    per-rank host resources stay constant across N: T(1 proc, 1 core)
    against T(N procs, N cores), efficiency = T1 / (N * TN).
  * --no-pin: every process on every core (for context; the 1-process
    run then already uses several threads, which understates scaling).

Each rank runs the pipeline twice: a cold pass in a fresh process (torch
start-up, the card's context, loading the kernel library) into a scratch
directory, then a steady pass (the long-lived process) whose outputs are
kept. Unless --no-warm, a discarded run at each process count first
builds the kernels and faults the BAM into the page cache.

    python -m floria_tpu_torch.scripts.multihost_bench [--contigs 500]
        [--procs 1,2,4] [--no-pin] [--no-warm] [--device cuda|cpu]
        [--base DIR] [--json PATH]

It prints one JSON line per run and a summary JSON (also written to
--json, build/floria_tpu_torch/multihost_bench.json by default), with
the card's nvidia-smi name and power limit on a card, and byte-compares
every N-process .vartigs and .haplosets against the 1-process run.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# Contigs of config #5; contig c is named mg{c:04d} and seeded 4000 + c.
CONTIGS = 500
CONTIG = dict(contig_len=60_000, num_strains=2, num_snps=300,
              coverage_per_strain=8.0, read_length=6_000,
              read_length_sd=1_000.0, error_rate=0.02)


def multi_configs(n: int):
    """The SimConfigs of the first `n` contigs of config #5."""
    from ..sim.simulate import SimConfig

    return [SimConfig(contig_name=f"mg{c:04d}", seed=4000 + c, **CONTIG)
            for c in range(n)]


def build_sim(n_contigs: int, base: str) -> None:
    """Simulate the metagenome into `base` unless its BAM is there: n
    contigs x 60 kb, 2 strains each, ~300 SNPs per contig, ~8x per
    strain of 6 kb reads (the 50-contig VALIDATION.md config scaled
    out)."""
    if os.path.exists(os.path.join(base, "sim.bam")):
        return
    from ..sim.simulate import simulate_multi

    t0 = time.time()
    simulate_multi(multi_configs(n_contigs), base)
    print(f"sim: built {n_contigs} contigs in {time.time() - t0:.0f}s",
          flush=True)


def _free_ports(n: int) -> str:
    """n distinct free localhost ports, comma-separated."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return ",".join(str(s.getsockname()[1]) for s in socks)
    finally:
        for s in socks:
            s.close()


def worker_main(args) -> None:
    """One rank: run_multihost twice on args.device (cold into a scratch
    directory, steady into args.out); its pass times and top stages go to
    rank<pid>.times.json for the parent."""
    from ..options import Options
    from ..parallel.multihost import run_multihost
    from .. import timing

    times = {}
    # Each pass hosts its own store: a rank that starts its second pass
    # while rank 0 still holds the first pass's store open must not
    # join that one.
    ports = args.port.split(",")
    for label, out, port in (("cold_s", args.out + ".warmup", ports[0]),
                             ("steady_s", args.out, ports[1])):
        options = Options(
            bam_file=os.path.join(args.base, "sim.bam"),
            vcf_file=os.path.join(args.base, "sim.vcf"),
            reference_fasta=os.path.join(args.base, "sim.fa"),
            out_dir=out, epsilon=0.02, block_length=6_000,
            overwrite=True)
        t0 = time.time()
        run_multihost(options, args.nproc, args.pid,
                      coordinator=f"127.0.0.1:{port}",
                      device=args.device)
        times[label] = round(time.time() - t0, 1)
        # run() resets the stage timers at entry: this pass's breakdown.
        times[label + "_stages"] = {
            k: round(v, 2) for k, v in sorted(
                timing.STAGE_TIMES.items(), key=lambda kv: -kv[1])[:12]}
    if args.pid == 0:
        shutil.rmtree(args.out + ".warmup", ignore_errors=True)
    with open(os.path.join(args.out,
                           f"rank{args.pid}.times.json"), "w") as fh:
        json.dump(times, fh)


def run_config(base: str, out: str, nproc: int, pin: bool, ncores: int,
               device: str, timeout: float = 14_400) -> float:
    """Spawn nproc ranks, return wall seconds (spawn -> all joined).
    A rank that fails (or the timeout) ends the run: the other ranks
    are killed and the first failed rank's log is raised."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    ports = _free_ports(2)
    os.makedirs(out, exist_ok=True)
    t0 = time.time()
    procs, logs = [], []
    try:
        for pid in range(nproc):
            cmd = [sys.executable, "-m",
                   "floria_tpu_torch.scripts.multihost_bench", "--worker",
                   "--base", base, "--out", out, "--nproc", str(nproc),
                   "--pid", str(pid), "--port", ports, "--device", device]
            if pin:
                cmd = ["taskset", "-c", str(pid % ncores)] + cmd
            # Files, never pipes: a rank blocked on a full pipe would
            # hold the others at the TSV-merge barrier.
            log = open(os.path.join(out, f"rank{pid}.log"), "wb")
            logs.append(log)
            procs.append(subprocess.Popen(cmd, env=env, stdout=log,
                                          stderr=subprocess.STDOUT))
        while (any(p.poll() is None for p in procs)
               and not any(p.returncode for p in procs)
               and time.time() - t0 < timeout):
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for pid, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(out, f"rank{pid}.log")) as fh:
                raise RuntimeError(f"rank {pid} of {nproc} exited "
                                   f"{p.returncode}:\n{fh.read()[-4000:]}")
    return time.time() - t0


def count_reads(out: str) -> int:
    n = 0
    for root, _dirs, files in os.walk(out):
        for f in files:
            if f.endswith(".haplosets"):
                with open(os.path.join(root, f)) as fh:
                    n += sum(1 for ln in fh if not ln.startswith(">"))
    return n


def compare_outputs(ref_out: str, out: str) -> int:
    """Byte-compare every .vartigs and .haplosets of two runs (their
    headers embed the output directory, written as O on both sides).
    Returns the number of files compared; raises on a difference."""
    n = 0
    for root, _dirs, files in os.walk(ref_out):
        for f in files:
            if not (f.endswith(".vartigs") or f.endswith(".haplosets")):
                continue
            rel = os.path.relpath(os.path.join(root, f), ref_out)
            with open(os.path.join(ref_out, rel)) as fa, \
                    open(os.path.join(out, rel)) as fb:
                a, b = fa.read(), fb.read()
            if a.replace(ref_out, "O") != b.replace(out, "O"):
                raise AssertionError(f"{rel} differs from the 1-process "
                                     "run")
            n += 1
    return n


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m floria_tpu_torch.scripts.multihost_bench")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--base")
    ap.add_argument("--out")
    ap.add_argument("--nproc", type=int)
    ap.add_argument("--pid", type=int)
    ap.add_argument("--port", help="the two passes' store ports, P1,P2")
    ap.add_argument("--contigs", type=int, default=CONTIGS)
    ap.add_argument("--procs", default="1,2,4")
    ap.add_argument("--no-pin", action="store_true")
    ap.add_argument("--no-warm", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; every rank on the host's card) "
                    "or cpu")
    ap.add_argument("--json", default=os.path.join(
        REPO, "build", "floria_tpu_torch", "multihost_bench.json"))
    args = ap.parse_args(argv)

    if args.worker:
        worker_main(args)
        return {}

    from ..device import resolve_device

    dev = resolve_device(args.device)
    ncores = os.cpu_count() or 4
    base = args.base or os.path.join(REPO, ".bench_cache", "torch",
                                     f"meta{args.contigs}")
    build_sim(args.contigs, base)

    pin = not args.no_pin
    results = {}
    ref_out = None
    for nproc in (int(x) for x in args.procs.split(",")):
        out = os.path.join(base, f"out_p{nproc}")
        if not args.no_warm:
            # A discarded pass per process count: the kernel build and
            # the page cache are one-time costs a long-lived deployment
            # does not pay per run.
            shutil.rmtree(out, ignore_errors=True)
            warm_wall = run_config(base, out, nproc, pin, ncores,
                                   args.device)
            print(json.dumps({"nproc": nproc, "warm_pass_wall_s":
                              round(warm_wall, 1)}), flush=True)
        shutil.rmtree(out, ignore_errors=True)
        shutil.rmtree(out + ".warmup", ignore_errors=True)
        wall = run_config(base, out, nproc, pin, ncores, args.device)
        reads = count_reads(out)
        # The slowest rank bounds each pass (the barrier).
        cold = steady = 0.0
        for pid in range(nproc):
            with open(os.path.join(out, f"rank{pid}.times.json")) as fh:
                t = json.load(fh)
            cold = max(cold, t["cold_s"])
            steady = max(steady, t["steady_s"])
        results[nproc] = {"wall_s": round(wall, 1),
                          "cold_s": cold, "steady_s": steady,
                          "steady_reads_per_sec": round(reads / steady, 1),
                          "reads": reads}
        if 1 in results and nproc > 1:
            for key, eff in (("cold_s", "cold_efficiency"),
                             ("steady_s", "steady_efficiency")):
                results[nproc][eff] = round(
                    results[1][key] / (nproc * results[nproc][key]), 3)
        print(json.dumps({"nproc": nproc, **results[nproc]}), flush=True)
        if ref_out is None:
            ref_out = out
        else:
            n = compare_outputs(ref_out, out)
            results[nproc]["outputs_match_1proc"] = n
            print(f"outputs byte-identical to 1-proc run ({n} files)",
                  flush=True)

    summary = {
        "config": f"{args.contigs}-contig metagenome "
                  f"(60kb x 2 strains x ~300 SNPs each)",
        "mode": "pinned 1 core/process" if pin else "unpinned",
        "device": str(dev),
        "card": None,
        "results": results,
    }
    if dev.type == "cuda":
        from ..bench import nvidia_smi_line

        summary["card"] = nvidia_smi_line()
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
    with open(args.json, "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
