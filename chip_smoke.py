"""Smoke run of the PyTorch port (floria_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--ab-inputs PATH]

It imports the standard library, numpy, torch and the port; nothing of
jax or of the JAX package `floria_tpu`, and it fails if either is loaded
by the end of the run. Phases, one JSON line
each; any failure raises (exit code != 0):
  1. device   - the card's name and power limit (nvidia-smi), torch/CUDA;
  2. build    - nvcc builds the kernels from floria_tpu_torch/csrc/ while
                g++ builds the port's copy of the native C++ library
                from native/ (floria_tpu_torch/native.py); ptxas's
                registers and spills per kernel; the run fails if K6's
                climb kernel or its evaluation kernel spills;
  3. kernels  - K1 (beam scan) against its plain PyTorch version, bitwise,
                at G=8 R=320 S=2048 (mixed ploidies 2..5, K1 in clusters
                of 8 CTAs; K1 also against the plain scan on the CPU),
                timed, plus a windowed and a dedup case; K4 (the UPEM
                move function, (assign, diff, num_reads, active) ->
                proposal) against its plain version on the sweep's first
                UPEM iteration, timed; K6 at the sweep's P=5 climb: its
                evaluation kernel's modes (init, step, unit MEC) against
                their plain version, and its climb kernel (the whole climb in
                one launch, clusters of 8 CTAs here) against
                upem_climb_plain, bitwise, both timed; the whole climb
                three ways with equal results, timed in turns
                (`climb_ab`): the climb kernel, the launch route (K6
                init, 20 x (K4 + K6 step), K6 mec) and the host loop
                (the torch evaluation and a wait per iteration);
  4. e2e      - the port's CLI (`--device cuda:0`: phases 3-7 use one card
                on any machine) on bench.py's `ecoli2` community (1 Mbp,
                2 strains, 50k SNPs, 50x per strain): a first run (its
                kernel launch counts: K1, K5 and K6, never K4), a second
                run (its K1 dispatches, K5 partitions and climbs
                recorded; exactly one K1 and one K6 climb per dispatch
                plus one K6 ploidy-1 MEC per fused level-2 dispatch, the
                two K6 kernels counted apart; every sweep
                level's launch under sync debug mode "error", so a host
                wait there fails the run, and each pull's host waits
                counted), a third run under torch.profiler (the card's
                busy share) and a `--device cpu` run; all four must
                write the same bytes;
  5. dispatch - K1, K4 and K6 (modes and climb kernel) against their
                plain versions on the card at the main path's own largest
                beam dispatch, recorded in phase 4, and on its blocks at
                the next ploidy, timed, with `climb_ab` there; K6's
                ploidy-1 MEC (the evaluation kernel's mec mode, as the
                fused level 2 launches it) at that dispatch, timed; K4 also at
                the later UPEM iterations that apply moves (the launch
                route's on the main path's climbs, on the next-ploidy
                dispatch and on phase 3's sweep), with their `active`
                masks, the one that moves the most reads timed;
  6. realign  - K5 (the realignment NW) against its plain version on the
                card (best alleles and scores) and against the native C++
                Gotoh on the host, bitwise, at the main path's own
                partition recorded in phase 4 (timed) and on adversarial
                windows at 4 alleles;
  7. parity   - the port's CLI on the `long3` community must write the
                oracle pipeline's bytes (tests/data/long3_oracle.json);
 7b. north_star - the port's CLI on the round's 12 small configs (the
                JAX package's oracle configs long2, long3, paired2, supp2,
                hybrid and its fuzz seeds 0-5 and 19): the simulated
                inputs and every output file held to the JAX CLI's
                sha256 in tests/data/north_star_golden.json; seconds and
                kernel launches per config;
 7c. config4  - BASELINE.json config #4, the 5-strain community (300 kbp,
                9,000 SNPs, `-p 6 -s 3`) at full size: three CLI runs in
                this process (first, second, traced), each held to the
                JAX CLI's hashes; stage times, launches, peak device
                memory, the card's busy share (traced); the second run's
                beam dispatches per sweep level, its climbs and the
                instances they moved, its climbs' inputs, and its levels
                launched under sync debug mode "error" with each pull's
                host waits counted; one K1 and one K6 per dispatch, one
                more K6 per fused level-2 dispatch, no K4; the outputs'
                vartig accuracy and haploset purity against the
                simulated truth, equal to the golden's;
 7d. tools    - vartig-dump, haplotagging (HAPQ >= 0) and a frags.txt
                round trip of get_frags_from_bam's fragments on long3,
                each output held to the JAX functions' hash;
 7e. upem_climb (run between 7c and 7d) - K6's climb kernel and its
                modes against their plain versions at every climb
                config4's second run recorded; at the largest dispatch of
                each level both timed and `climb_ab`;
  8. parallel - the parallel layer (floria_tpu_torch/parallel/), two
                shards on the one card (one shard per card where the
                machine has more): (a) K1 through beam_search_sharded (the
                reference's API twin; the CLI's sweep splits its
                dispatches itself, as (b) runs it) at phase 4's largest
                dispatch, bitwise equal to the unsharded K1 call on
                cuda:0 and to the plain scan, one K1 launch per shard,
                both calls timed; (b) adaptive_sweep through the sharded
                dispatch on the kernel sweep's workload, equal to the
                sweep on cuda:0 alone, both timed; (c) entry.py's
                dryrun_multichip; (d) the CLI as two ranks
                (--num-processes 2, the coordinator on localhost, each
                rank's blocks over every card) against
                one process on BASELINE.json config #5's community
                (scripts/multihost_bench.py `build_sim`: 500 contigs of 60
                kbp, 2 strains, 300 SNPs, 8x per strain, 6 kbp reads): the
                same bytes, each rank's launch counts (every rank must
                launch K1 and K6, none K4), both wall times;
  9. summary  - K1's and K4's times at the `ecoli2` dispatch (P=2, P=3)
                and on the sweep, and K4's at the timed later iteration,
                beside their bounds and the `ecoli2` launch counts; K6's
                (`k6_summary`): the climb kernel's times, whole call and
                alone, beside its bound and its per-pass figure, the
                evaluation kernel's init times (one evaluation alone) and
                its ploidy-1 MEC's, launches per
                `ecoli2`, `multi500` and `config4` run, the climbs three
                ways, `phase.launch` / `phase.wait`, host waits per
                level, idle shares and peak memory; the run fails if any
                jax or `floria_tpu` module is loaded.
With --ab-inputs it also saves the inputs of every timed K4, K5 and climb
case, for scripts/torch_kernel_parent_ab.py to time an earlier tree's
calls on them.
Times are medians of 3 (K4, K6: 20; climbs in `climb_ab`: 5) after one
warm run of the whole call, wrapper included, CUDA-synchronized
(`kernel_ms`, the kernel line's `ms`); beside them `kernel_device_ms` is
the kernel alone on the card, from torch.profiler's CUDA activity. Every
record that holds a time carries the card's name and power limit
(`card`). Each kernel's bound is computed from this run's inputs: the
larger of the bytes the function must move (each input read once, each
output written once) over 3.35 TB/s and its operations over 67 T/s (the
H100 SXM's HBM rate and its f32 rate outside the tensor cores, NVIDIA's
data sheet; integer operations are counted at that rate, which makes the
bound a lower one). The climb kernel's (`k6_climb_once_bound`) reads
its inputs once and writes its outputs once, with the operations of
every evaluation the climb made on these inputs; beside it,
`k6_climb_bound` (`pass_bound_ms`) counts the bytes of every pass the
climb makes over the cells (1 + E evaluations and the MEC pass), which
may come from L2. No single PyTorch call computes any of the kernels,
so `library_ms` is null. The kernel line has a row per kernel: K6's
climb kernel (`upem_climb`) at the `ecoli2` dispatch, launched once per
climb, and its evaluation kernel (`upem_eval`) in the ploidy-1 MEC at
that dispatch's shape, launched once per fused level-2 dispatch; K4's
launches on the main path are 0 (its body runs inside the climb
kernel). The last lines
are the kernel table, the nvidia-smi line and {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import filecmp
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# `nvidia-smi` name and power limit, set in main() and written beside
# every time.
CARD = None
GOLDEN_LONG3 = os.path.join(REPO, "tests", "data", "long3_oracle.json")
# The JAX CLI's output hashes on the round's configs and the JAX tools'
# on long3 (written by tests/test_torch_oracle_configs.py); OUT_MARK and
# SIM_MARK stand there for the run's -o and its inputs' directory.
GOLDEN_NORTH_STAR = os.path.join(REPO, "tests", "data",
                                 "north_star_golden.json")
OUT_MARK, SIM_MARK = "<out>", "<sim>"
# bench.py's `ecoli2` e2e community (bench.py:134).
ECOLI2 = dict(contig_len=1_000_000, num_strains=2, num_snps=50_000,
              coverage_per_strain=50.0, read_length=9_000,
              read_length_sd=1_500.0, error_rate=0.02, seed=11)


# scripts/multihost_bench.py's `build_sim` community, BASELINE.json's
# config #5 (a 500-contig assembly sharded over processes), one contig's
# SimConfig fields; contig c is named mg{c:04d} and seeded 4000 + c.
MULTI_CONTIG = dict(contig_len=60_000, num_strains=2, num_snps=300,
                    coverage_per_strain=8.0, read_length=6_000,
                    read_length_sd=1_000.0, error_rate=0.02)
MULTI_CONTIGS = 500


def multi_configs(n):
    from floria_tpu_torch.sim.simulate import SimConfig

    return [SimConfig(contig_name=f"mg{c:04d}", seed=4000 + c,
                      **MULTI_CONTIG) for c in range(n)]


def make_workload(G, R, S, num_strains=3, epsilon=0.02, seed=0):
    """bench.py's `make_workload` (the kernel sweep's synthetic blocks:
    G instances of R reads, each covering half of S sites, sorted by
    start), copied so the smoke needs nothing of the JAX package's
    benchmark; a CPU test holds the two equal."""
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


def emit(obj) -> None:
    if CARD is not None and any(k.endswith(("_ms", "_s")) for k in obj):
        obj = {**obj, "card": CARD}
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the least time for `nbytes` of traffic and
    `ops` operations on the card."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def k1_bound(al, nr, npt, P, W):
    """K1's bound on these inputs: each real read's alleles (1 B) and
    weights (4 B) over its covered span, read once; the records, scores,
    live flags and assignments written once; per (active part, covered
    column) of each read one comparison and one addition against at
    least one slot."""
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
    return bound(nbytes, 2 * int((ncov * npt.long()).sum()))


def k4_bound(assign, diff, num_reads):
    """K4's bound over the whole move function: `diff`, `assign` and
    `num_reads` read once and the proposal written once; per candidate
    move (r, j) one subtraction and one comparison."""
    nbytes = (diff.numel() * 8 + assign.numel() * 4 * 2
              + num_reads.numel() * 4)
    return bound(nbytes, 2 * diff.numel())


def k5_bound(q, si, nal, ref_tab, al_tab, a_max):
    """K5's bound: the jobs and tables read and one byte per job
    written once; 32 x 32 DP cells of ten integer operations for each
    allele a job tries (min(nal, a_max))."""
    nbytes = (q.numel() + si.numel() * 4 + nal.numel() * 4
              + ref_tab.numel() + al_tab.numel() + q.shape[0])
    cells = 32 * 32 * int(nal.clamp(max=a_max).sum())
    return bound(nbytes, 10 * cells)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed(fn, reps=3):
    """Median seconds of `reps` runs after one warm run (synchronized)."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def kernel_device_ms(fn, kernel: str, reps=10):
    """Device time per launch of the CUDA kernels whose name holds
    `kernel` (each `fn` here launches one), from torch.profiler's CUDA
    activity over `reps` calls after one warm call: the kernel alone,
    without the wrapper's host work or the launch. The mean over the
    launches the trace holds (a trace may miss some). None when it
    shows no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and kernel in e.name]
    return sum(spans) / len(spans) * 1e-3 if spans else None


def event_ms(fn, reps=20):
    """Milliseconds per call of `fn` between two CUDA events around
    `reps` calls enqueued back to back, after one warm call: the card's
    time per call when the host enqueues faster than the card runs, else
    the host's."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype mismatch {a.shape} {a.dtype} "
                             f"vs {b.shape} {b.dtype}")
    if torch.equal(a, b):
        return 0.0
    d = (a.to(torch.float64) - b.to(torch.float64)).abs()
    return float(torch.nan_to_num(d, nan=float("inf")).max())


def dedup_case():
    """One early short read, then reads far downstream: chains that
    differ only in the early read's part become identical truncated
    blocks, which dedup must merge."""
    from floria_tpu_torch import state

    rng = np.random.default_rng(0)
    P, S, R = 3, 64, 40
    alleles = np.full((1, R, S), -1, np.int8)
    quals = np.zeros((1, R, S), np.uint8)
    alleles[0, 0, 0:3] = [0, 1, 0]
    quals[0, 0, 0:3] = 30
    strains = rng.integers(0, 2, (P, S))
    starts = np.sort(rng.integers(29, 44, R - 1))
    for i, s0 in enumerate(starts, start=1):
        k = rng.integers(0, P)
        hap = strains[k, s0:s0 + 12].copy()
        err = rng.random(12) < 0.03
        hap[err] = 1 - hap[err]
        alleles[0, i, s0:s0 + 12] = hap
        quals[0, i, s0:s0 + 12] = rng.integers(10, 40, 12)
    weights = state.phred_table()[quals]
    return (alleles, weights, np.array([R], np.int32),
            np.array([0.03], np.float32), np.array([P], np.int32), P)


def windowed_case(G=4, R=320, S=2048, span=200, seed=3):
    rng = np.random.default_rng(seed)
    strains = rng.integers(0, 2, (G, 3, S))
    alleles = np.full((G, R, S), -1, np.int8)
    weights = np.zeros((G, R, S), np.float32)
    starts = np.sort(rng.integers(0, S - span, (G, R)), axis=1)
    for g in range(G):
        for r in range(R):
            s0 = starts[g, r]
            hap = strains[g, rng.integers(0, 3), s0:s0 + span].copy()
            err = rng.random(span) < 0.02
            hap[err] = 1 - hap[err]
            alleles[g, r, s0:s0 + span] = hap
            weights[g, r, s0:s0 + span] = 1.0 - 10.0 ** (
                rng.integers(10, 40, span) / -10.0)
    nreads = np.full(G, R, np.int32)
    nreads[-1] = R - 17
    return (alleles, weights, nreads, np.full(G, 0.02, np.float32),
            np.full(G, 3, np.int32), 3)


def nw_case(n=1000, T=97, A=4, seed=0):
    """Realignment jobs at A alleles, with the adversarial windows of
    tests/test_native_nw.py (exact variants, scattered mismatches, 1-3
    base shifts, random windows) and a fifth kind that drives the DP to
    its extremes (a homopolymer query against a homopolymer row of
    another base, or a 16-base shift); allele counts 0..A. Returns numpy
    (q_packed [n, 16] u8, si [n] i32, nal [n] i32, ref_tab [T, 32] u8,
    al_tab [T, A] u8)."""
    rng = np.random.default_rng(seed)
    W, F = 32, 16
    ref_tab = rng.integers(0, 16, (T, W)).astype(np.uint8)
    ref_tab[::5] = 1
    al_tab = rng.integers(1, 16, (T, A)).astype(np.uint8)
    nal_tab = rng.integers(0, A + 1, T).astype(np.int32)
    si = rng.integers(0, T, n).astype(np.int32)
    q = np.empty((n, W), np.uint8)
    for i in range(n):
        kind = i % 5
        if kind == 4 and i % 10 == 4:
            si[i] = 5 * rng.integers(0, (T + 4) // 5)
        t = si[i]
        w = ref_tab[t].copy()
        if kind == 0:
            w[F] = al_tab[t, rng.integers(0, max(1, nal_tab[t]))]
        elif kind == 1:
            w[rng.integers(0, W, rng.integers(1, 6))] = rng.integers(0, 16)
        elif kind == 2:
            s = int(rng.integers(1, 4))
            w = np.concatenate([w[s:], rng.integers(0, 16, s).astype(
                np.uint8)])
        elif kind == 3:
            w = rng.integers(0, 16, W).astype(np.uint8)
        elif t % 5 == 0:
            w[:] = 2
        else:
            w = np.concatenate([rng.integers(0, 16, F).astype(np.uint8),
                                w[:F]])
        q[i] = w
    q_packed = (q[:, 0::2] | (q[:, 1::2] << 4)).astype(np.uint8)
    return q_packed, si, nal_tab[si], ref_tab, al_tab


def _assert_beam_equal(label, ref, ref_asg, got, asg) -> float:
    """Max abs difference over records, scores, live and assignments;
    raises unless all are bitwise equal."""
    err = 0.0
    for name, a, b in zip(ref._fields + ("assign",), tuple(ref) +
                          (ref_asg,), tuple(got) + (asg,)):
        e = max_abs_diff(a, b)
        if e != 0.0 or not torch.equal(a, b):
            raise AssertionError(f"K1 {label}: {name} differs from the "
                                 f"plain scan (max abs {e})")
        err = max(err, e)
    return err


def check_beam(dev, alleles, weights, nreads, eps, nparts, P, W=10, A=2,
               window=0, label="", timing=False, cpu_ref=False):
    """K1 against the plain scan on the same card (and, with cpu_ref, on
    the CPU); inputs are numpy arrays or tensors. Returns (max_abs_err,
    kernel_s, plain_s, (alleles, weights, num_reads, eps, assign),
    (bound_ms, bound_by))."""
    from floria_tpu_torch.kernels import beam as tb

    al, wt, nr, ep, npt = tb._inputs(alleles, weights, nreads, eps,
                                     nparts, dev)
    S = al.shape[-1]
    window = S if window <= 0 or window >= S else window
    prep = tb._prepare(al, wt, ep, A, P, window, True)
    args = (al, wt, nr, *prep[:2], npt, *prep[2:])
    kw = dict(P=P, W=W, A=A, window=window, dedup=True)
    got, asg = tb.beam_scan_cuda(*args[:6], **kw)
    ref = tb.beam_scan_plain(*args, **kw)
    err = _assert_beam_equal(label, ref, tb.traceback_batch(ref), got,
                             asg)
    cpu_s = None
    if cpu_ref:
        t0 = time.perf_counter()
        ref = tb.beam_scan_plain(*(x.cpu() for x in args), **kw)
        cpu_s = time.perf_counter() - t0
        err = max(err, _assert_beam_equal(
            label + " (plain on the CPU)", ref, tb.traceback_batch(ref),
            type(got)(*(x.cpu() for x in got)), asg.cpu()))
    k_s = p_s = dev_ms = None
    if timing:
        k_s = timed(lambda: tb.beam_scan_cuda(*args[:6], **kw))
        p_s = timed(lambda: tb.traceback_batch(
            tb.beam_scan_plain(*args, **kw)))
        dev_ms = kernel_device_ms(lambda: tb.beam_scan_cuda(*args[:6], **kw),
                                  "beam_scan_kernel", reps=3)
    bnd = k1_bound(al, nr, npt, P, W)
    emit({"phase": "kernels", "kernel": "beam_scan", "case": label,
          "G": int(al.shape[0]), "R": int(al.shape[1]), "S": int(S),
          "P": P, "num_parts": sorted(set(npt.tolist())),
          "window": int(window),
          "cluster_width": tb.cluster_width(int(al.shape[0]), dev),
          "bitwise_equal": True,
          "cpu_plain_bitwise_equal": cpu_ref or None,
          "cpu_plain_s": cpu_s,
          "kernel_ms": None if k_s is None else k_s * 1e3,
          "kernel_device_ms": dev_ms,
          "plain_ms": None if p_s is None else p_s * 1e3,
          "bound_ms": bnd[0], "bound_by": bnd[1]})
    return err, k_s, p_s, (al, wt, nr, ep, asg), bnd


# The inputs of every timed K4, K5 and climb case, by the call timed and
# label, kept for --ab-inputs.
AB_CASES = {"upem_moves": {}, "nw_best": {}, "upem_optimize_device": {}}


def check_moves(assign, diff, nr, P, label="", timing=True, active=None):
    """K4, the whole move function (assign, diff, num_reads, active) ->
    proposal, against its plain version (the candidates and their stable
    sort in torch, the walk on the host) on the same card, bitwise;
    timed. Returns (max_abs_err, kernel_s, plain_s, (bound_ms,
    bound_by))."""
    from floria_tpu_torch.kernels import upem_batch as tu

    assign = assign.to(torch.int32).contiguous()
    diff = diff.contiguous()
    nr = nr.to(torch.int32).contiguous()
    got = tu.apply_moves_cuda(assign, diff, nr, active)
    ref = tu.apply_moves_plain(assign, diff, nr, active)
    err = max_abs_diff(ref, got)
    if err != 0.0 or not torch.equal(got, ref):
        raise AssertionError(f"K4 {label} differs from the plain move "
                             f"function (max abs {err})")
    n_valid = tu._move_candidates(assign, diff, nr)[2]
    k_s = p_s = dev_ms = None
    if timing:
        # A call is tens of us of host work: 20 runs steady the median.
        k_s = timed(lambda: tu.apply_moves_cuda(assign, diff, nr, active),
                    reps=20)
        p_s = timed(lambda: tu.apply_moves_plain(assign, diff, nr, active),
                    reps=20)
        dev_ms = kernel_device_ms(
            lambda: tu.apply_moves_cuda(assign, diff, nr, active),
            "upem_moves_kernel")
        AB_CASES["upem_moves"][label] = tuple(x.cpu()
                                              for x in (assign, diff, nr))
    bnd = k4_bound(assign, diff, nr)
    G, R = assign.shape
    emit({"phase": "kernels", "kernel": "upem_moves", "case": label,
          "G": G, "R": R, "P": P,
          "shared_memory": tu.moves_in_shared(R, P, assign.device),
          "active": G if active is None else int(active.sum()),
          "n_valid": int(n_valid.sum()), "n_valid_max": int(n_valid.max()),
          "moves_applied": int((got != assign).sum()),
          "bitwise_equal": True,
          "kernel_ms": None if k_s is None else k_s * 1e3,
          "kernel_device_ms": dev_ms,
          "plain_ms": None if p_s is None else p_s * 1e3,
          "bound_ms": bnd[0], "bound_by": bnd[1]})
    return err, k_s, p_s, bnd


def check_first_moves(ups, P, A=2, label=""):
    """K4 on the first UPEM iteration's input: the beam's assignments,
    with `ups` = check_beam's (alleles, weights, num_reads, eps,
    assign)."""
    from floria_tpu_torch.kernels import upem_batch as tu

    al, wt, nr, ep, asg = ups
    assign = asg.to(torch.int32).contiguous()
    diff, _score = tu._eval_diff_score(al, wt, assign, ep, P, A)
    return check_moves(assign, diff, nr, P, label=label)


class MovesRecorder:
    """Keeps the inputs and outputs of every move-function call (K4) of
    the climbs' launch route run while active, with each call's round in
    its climb. The inputs are copied: the climb refines its assignment and
    distances in place."""

    def __init__(self):
        from floria_tpu_torch import constants
        from floria_tpu_torch.kernels import upem_batch

        self.module = upem_batch
        self.rounds = constants.NUM_ITER_OPTIMIZE  # calls per climb
        self.calls = []

    def __enter__(self):
        self._apply = self.module.apply_moves

        def apply_moves(assign, diff, num_reads, active=None):
            out = self._apply(assign, diff, num_reads, active)
            self.calls.append((len(self.calls), assign.clone(),
                               diff.clone(), num_reads, None
                               if active is None else active.clone(), out))
            return out

        self.module.apply_moves = apply_moves
        return self

    def __exit__(self, *exc):
        self.module.apply_moves = self._apply

    def later_with_moves(self, label):
        """The calls past a climb's first round that applied moves, as
        (label round k, (assign, diff, num_reads, active, proposal))."""
        n = self.rounds
        return [(f"{label} iteration {c[0] % n}", c[1:]) for c in self.calls
                if c[0] % n >= 1 and not torch.equal(c[5],
                                                     c[1].to(c[5].dtype))]


def climb_launch_route(alleles, weights, assign0, num_reads, epsilon, P,
                       A):
    """The climb as launches, the port's route before the climb kernel:
    K6 init, NUM_ITER_OPTIMIZE rounds of K4 (masked by the instances'
    `active` flags) and K6 step, K6 mec, with no host wait; composed from
    the kernels' wrappers. The second arm of `climb_ab`. Returns (best,
    mec, diff in weight units)."""
    from floria_tpu_torch.kernels import upem_batch as tu

    best, mec, diff = tu._climb(alleles, weights, assign0.clone(),
                                num_reads, epsilon, P, A, early_exit=False)
    return best, mec, diff * tu.INV_WEIGHT_SCALE


def upem_loop_moves(ups, P, A, label):
    """Runs the climb's launch route at ploidy P on `ups` = check_beam's
    (alleles, weights, num_reads, eps, assign) and returns (its number of
    move calls, its later calls that applied moves)."""
    al, wt, nr, ep, asg = ups
    with MovesRecorder() as rec:
        climb_launch_route(al, wt, asg.to(torch.int32).contiguous(),
                           nr.to(torch.int32).contiguous(), ep, P, A)
    return len(rec.calls), rec.later_with_moves(label)


def check_later_moves(later):
    """K4 against its plain version on every later UPEM iteration in
    `later` ([(label, (assign, diff, num_reads, active, proposal))]),
    with the iteration's `active` mask; the one that moves the most
    reads is timed. Returns (max_abs_err, kernel_s, plain_s, bound,
    label) of that one, or None when `later` is empty."""
    if not later:
        return None
    timed_label = max(later, key=lambda x: int((x[1][4] != x[1][0])
                                              .sum()))[0]
    err, out = 0.0, None
    for label, (assign, diff, num_reads, active, _prop) in later:
        res = check_moves(assign, diff, num_reads, diff.shape[2],
                          label=label, timing=label == timed_label,
                          active=active)
        err = max(err, res[0])
        if label == timed_label:
            out = res
    return (err, *out[1:], timed_label)


def k6_bound(alleles, P):
    """K6's bound for one full evaluation of every instance (mode
    "init"): each cell's allele (1 B) and weight (4 B) and each read's
    assignment (4 B) read once, `diff` (8 B per read and part) and the
    score written once; about P + 2 operations per cell."""
    G, R, S = alleles.shape
    cells = G * R * S
    return bound(cells * 5 + G * R * (4 + 8 * P) + G * 8, cells * (P + 2))


def k6_climb_ops(alleles, evaluations, P):
    """The operations of the climb on these inputs: per instance, 1 + E
    full evaluations of about P + 2 operations per cell (E, the rounds
    that evaluated a changed proposal, counted by upem_climb_plain on the
    same inputs) and the unit MEC pass, two per cell."""
    G, R, S = alleles.shape
    runs = int((1 + evaluations).sum())
    return runs * R * S * (P + 2) + G * R * S * 2


def k6_climb_once_bound(alleles, evaluations, P):
    """The climb kernel's bound on these inputs: each input read once
    (allele 1 B and weight 4 B per cell, assign0 4 B per read, num_reads
    and epsilon 4 B per instance), each output written once (best 4 B
    per read, diff 8 B per read and part, mec 16 B per instance), and
    the operations of every evaluation it made (k6_climb_ops)."""
    G, R, S = alleles.shape
    nbytes = G * R * S * 5 + G * R * (4 + 4 + 8 * P) + G * (8 + 16)
    return bound(nbytes, k6_climb_ops(alleles, evaluations, P))


def k6_climb_bound(alleles, evaluations, P):
    """The climb's per-pass figure, not a bound on the kernel: the bytes
    of every pass it makes over the cells, 1 + E full evaluations
    (k6_bound's bytes of one instance) and the unit MEC pass (each
    cell's allele, 1 B), as if none came from L2."""
    G, R, S = alleles.shape
    cells = R * S
    one = cells * 5 + R * (4 + 8 * P) + 8
    runs = int((1 + evaluations).sum())
    return bound(runs * one + G * cells,
                 k6_climb_ops(alleles, evaluations, P))


def k6_mec_bound(alleles):
    """K6's bound for the unit MEC of every instance (mode "mec"): each
    cell's allele (1 B), each read's assignment (4 B) and each epsilon
    read once, (bases, errors) written once; two operations per cell."""
    G, R, S = alleles.shape
    return bound(G * R * S + G * R * 4 + G * (4 + 16), 2 * G * R * S)


def check_climb(ups, P, A, label, timing=False):
    """K6's climb kernel (the whole climb in one launch) against
    upem_climb_plain on the same card, bitwise on best, mec and diff, at
    a climb's inputs `ups` = (alleles, weights, num_reads, eps, assign0).
    With `timing`: the kernel's whole call (20 runs), the kernel alone
    and the plain version. Returns (max_abs_err, kernel_s, plain_s,
    (bound_ms, bound_by), record)."""
    from floria_tpu_torch.kernels import upem_batch as tu

    al, wt, nr, ep, asg = ups
    asg = asg.to(torch.int32).contiguous()
    nr = nr.to(torch.int32).contiguous()
    G, R, S = al.shape
    evals = torch.zeros(G, dtype=torch.int64, device=al.device)
    want = tu.upem_climb_plain(al, wt, asg, nr, ep, P, A, evaluations=evals)
    got = tu.upem_climb_cuda(al, wt, asg, nr, ep, P, A)
    errs = [max_abs_diff(a, b) for a, b in zip(want, got)]
    if max(errs) != 0.0 or not all(torch.equal(a, b)
                                   for a, b in zip(want, got)):
        raise AssertionError(f"climb kernel {label} differs from "
                             f"upem_climb_plain (best, mec, diff: {errs})")
    bnd = k6_climb_once_bound(al, evals, P)
    sms, limit = tu.card(al.device)
    C, lay, shared, _arr = tu.climb_plan(G, R, S, P, A, sms, limit)
    rec = {"phase": "kernels", "kernel": "upem_climb", "case": label,
           "G": G, "R": R, "S": S, "P": P, "A": A, "cluster": C,
           "shared_memory": shared, "region_bytes": lay.head + lay.stride,
           "evaluations": int((1 + evals).sum()),
           "rounds_max": int(evals.max()),
           "moved_instances": int((got[0] != asg).any(dim=1).sum()),
           "bitwise_equal": ["best", "mec", "diff"],
           "bound_ms": bnd[0], "bound_by": bnd[1],
           "pass_bound_ms": k6_climb_bound(al, evals, P)[0]}
    k_s = p_s = None
    if timing:
        def kernel():
            return tu.upem_climb_cuda(al, wt, asg, nr, ep, P, A)

        k_s = timed(kernel, reps=20)
        p_s = timed(lambda: tu.upem_climb_plain(al, wt, asg, nr, ep, P, A))
        rec.update(
            kernel_ms=k_s * 1e3, plain_ms=p_s * 1e3,
            kernel_device_ms=kernel_device_ms(kernel, "upem_climb_kernel"),
            kernel_event_ms=event_ms(kernel))
        AB_CASES["upem_optimize_device"][label] = (
            *(x.cpu() for x in (al, wt, asg, nr, ep)), P, A)
    emit(rec)
    return 0.0, k_s, p_s, bnd, rec


def check_eval(ups, P, A, label, timing=False):
    """K6's evaluation kernel against its plain version on the card,
    bitwise, at a climb's own inputs `ups` = (alleles, weights,
    num_reads, eps, assign0): init
    (the distances and score of assign0); one step over three kinds of
    instance (g % 3): the climb's first proposal (K4 on init's result),
    a worse proposal (assign0 against the climb's result) and an
    unchanged one; and the unit MEC of assign0. With `timing`, K6's init
    call (a full evaluation of every instance) and its plain version are
    timed (the redesigned evaluation alone). Returns (max_abs_err,
    kernel_s, plain_s, (bound_ms, bound_by), kernel_device_ms)."""
    from floria_tpu_torch.kernels import upem_batch as tu

    al, wt, nr, ep, asg = ups
    asg = asg.to(torch.int32).contiguous()
    nr = nr.to(torch.int32).contiguous()
    got = tu.upem_eval_cuda("init", al, wt, asg, ep, P, A)
    want = tu.upem_eval_plain("init", al, wt, asg, ep, P, A)
    errs = [max_abs_diff(a, b) for a, b in zip(want, got)]
    first = tu.apply_moves_cuda(asg, want[0], nr, want[2])
    refined = tu.upem_optimize_device(al, wt, asg, nr, ep, P, A,
                                      device=al.device)[0]
    kind = (torch.arange(al.shape[0], device=al.device) % 3)[:, None]
    best = torch.where(kind == 0, asg, refined).contiguous()
    proposal = torch.where(kind == 0, first, torch.where(
        kind == 1, asg, refined)).contiguous()
    diff, score, active = tu.upem_eval_plain("init", al, wt, best, ep, P, A)
    states = [tuple(x.clone() for x in (best, score, diff, active))
              for _ in range(2)]
    tu.upem_eval_cuda("step", al, wt, proposal, ep, P, A, states[0])
    tu.upem_eval_plain("step", al, wt, proposal, ep, P, A, states[1])
    errs += [max_abs_diff(b, a) for a, b in zip(*states)]
    mec = tu.upem_eval_cuda("mec", al, wt, asg, ep, P, A)
    errs.append(max_abs_diff(tu.upem_eval_plain("mec", al, wt, asg, ep, P,
                                                A), mec))
    err = max(errs)
    if err != 0.0:
        raise AssertionError(f"K6 {label} differs from its plain version "
                             f"(max abs {err}; init, step, mec: {errs})")
    G, R, S = al.shape
    bnd = k6_bound(al, P)
    k_s = p_s = dev_ms = None
    if timing:
        k_s = timed(lambda: tu.upem_eval_cuda("init", al, wt, asg, ep, P, A),
                    reps=20)
        p_s = timed(lambda: tu.upem_eval_plain("init", al, wt, asg, ep, P,
                                               A))
        dev_ms = kernel_device_ms(
            lambda: tu.upem_eval_cuda("init", al, wt, asg, ep, P, A),
            "upem_eval_kernel")
    emit({"phase": "kernels", "kernel": "upem_eval", "case": label,
          "G": G, "R": R, "S": S, "P": P, "A": A,
          "shared_memory": tu.eval_in_shared(R, S, P, A, al.device),
          "step_accepted": int(states[1][3].sum()),
          "step_instances": G, "bitwise_equal": ["init", "step", "mec"],
          "kernel_ms": None if k_s is None else k_s * 1e3,
          "kernel_device_ms": dev_ms,
          "plain_ms": None if p_s is None else p_s * 1e3,
          "bound_ms": bnd[0], "bound_by": bnd[1]})
    return err, k_s, p_s, bnd, dev_ms


def check_mec1(ups, A, label):
    """K6's evaluation kernel in the ploidy-1 MEC as the fused 1+2 sweep
    level launches it (mode "mec", P = 1, every row in part 0) at a
    dispatch's inputs `ups` (as check_eval's), against its plain version,
    bitwise; timed (20 runs), alone and the plain version. Returns
    (max_abs_err, kernel_s, plain_s, (bound_ms, bound_by),
    kernel_device_ms)."""
    from floria_tpu_torch.kernels import upem_batch as tu

    al, wt, _nr, ep, _asg = ups
    zeros = torch.zeros(al.shape[:2], dtype=torch.int32, device=al.device)
    G, R, S = al.shape

    def kernel():
        return tu.upem_eval_cuda("mec", al, wt, zeros, ep, 1, A)

    def plain():
        return tu.upem_eval_plain("mec", al, wt, zeros, ep, 1, A)

    err = max_abs_diff(plain(), kernel())
    if err != 0.0:
        raise AssertionError(f"K6 ploidy-1 MEC {label} differs from its "
                             f"plain version (max abs {err})")
    bnd = k6_mec_bound(al)
    k_s, p_s = timed(kernel, reps=20), timed(plain, reps=20)
    dev_ms = kernel_device_ms(kernel, "upem_eval_kernel")
    emit({"phase": "kernels", "kernel": "upem_eval", "case": label,
          "mode": "mec", "G": G, "R": R, "S": S, "P": 1, "A": A,
          "shared_memory": tu.eval_in_shared(R, S, 1, A, al.device),
          "bitwise_equal": ["mec"], "kernel_ms": k_s * 1e3,
          "kernel_device_ms": dev_ms, "kernel_event_ms": event_ms(kernel),
          "plain_ms": p_s * 1e3, "bound_ms": bnd[0], "bound_by": bnd[1]})
    return err, k_s, p_s, bnd, dev_ms


def climb_host_loop(alleles, weights, assign0, num_reads, epsilon, P, A):
    """The climb as the port ran it before K6: the plain f64 evaluation
    in torch ops, K4 without a mask, and a host wait on `active.any()`
    before every iteration. The yardstick of `climb_ab`; the port no
    longer runs it. Returns (best, mec, diff in weight units,
    iterations)."""
    from floria_tpu_torch import constants
    from floria_tpu_torch.kernels import upem_batch as tu

    best = assign0.clone()
    diff, best_score = tu._eval_diff_score(alleles, weights, best, epsilon,
                                           P, A)
    active = torch.ones(best.shape[0], dtype=torch.bool, device=best.device)
    it = 0
    while it < constants.NUM_ITER_OPTIMIZE and bool(active.any()):
        proposal = tu.apply_moves_cuda(best, diff, num_reads)
        active = active & (proposal != best).any(dim=1)
        new_diff, new_score = tu._eval_diff_score(alleles, weights,
                                                  proposal, epsilon, P, A)
        improved = active & (new_score > best_score)
        best = torch.where(improved[:, None], proposal, best)
        best_score = torch.where(improved, new_score, best_score)
        diff = torch.where(improved[:, None, None], new_diff, diff)
        active = improved
        it += 1
    mec = tu._eval_mec(alleles, best, epsilon, P, A)
    return best, mec, diff * tu.INV_WEIGHT_SCALE, it


def climb_ab(ups, P, A, label):
    """The whole climb at one dispatch's inputs `ups` (as check_eval's),
    three arms with equal results, timed in turns in this call (host
    loop, launch route, kernel, kernel, launch route, host loop): the
    port's route, one launch of K6's climb kernel (`upem_optimize_device`
    on the card); the launch route (climb_launch_route: K6 init, 20 x
    (K4 + K6 step), K6 mec); and climb_host_loop. Also the two card
    routes' enqueue time on the host clock. Returns the record."""
    from floria_tpu_torch.kernels import upem_batch as tu

    al, wt, nr, ep, asg = ups
    asg = asg.to(torch.int32).contiguous()
    nr = nr.to(torch.int32).contiguous()

    def kernel():
        return tu.upem_optimize_device(al, wt, asg, nr, ep, P, A,
                                       device=al.device)

    def route():
        return climb_launch_route(al, wt, asg, nr, ep, P, A)

    def host_loop():
        return climb_host_loop(al, wt, asg, nr, ep, P, A)

    got, routed, (*want, iters) = kernel(), route(), host_loop()
    for name, a, b, c in zip(("best", "mec", "diff"), want, got, routed):
        if not (torch.equal(a, b) and torch.equal(a, c)):
            raise AssertionError(f"climb {label}: {name} differs between "
                                 "the kernel, the launch route and the "
                                 "host loop")
    t = [timed(f, reps=5) * 1e3
         for f in (host_loop, route, kernel, kernel, route, host_loop)]
    enqueue = {}
    for name, f in (("kernel", kernel), ("launch_route", route)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f()
        enqueue[name] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    G, R, S = al.shape
    rec = {"phase": "upem_climb", "case": label, "G": G, "R": R, "S": S,
           "P": P, "host_loop_iterations": iters,
           "moved_instances": int((got[0] != asg).any(dim=1).sum()),
           "equal": ["kernel", "launch_route", "host_loop"],
           "climb_ms": t[2:4], "launch_route_ms": [t[1], t[4]],
           "host_loop_ms": [t[0], t[5]],
           "climb_enqueue_ms": enqueue["kernel"],
           "launch_route_enqueue_ms": enqueue["launch_route"]}
    if max(rec["climb_ms"]) > min(rec["launch_route_ms"]):
        rec["kernel_slower_than_launch_route"] = True
    emit(rec)
    return rec


class ClimbRecorder:
    """Keeps the inputs of every UPEM climb the sweep runs while active,
    as (ploidy, (alleles, weights, num_reads, eps, assign0),
    max_alleles). The climb copies assign0 before refining it."""

    def __init__(self):
        from floria_tpu_torch.phase import local

        self.local = local
        self.climbs = []

    def __enter__(self):
        self._upem = self.local.upem_optimize_device

        def upem(alleles, weights, assign0, nr, ep, ploidy, max_alleles, *,
                 device):
            self.climbs.append((ploidy, (alleles, weights, nr, ep, assign0),
                                max_alleles))
            return self._upem(alleles, weights, assign0, nr, ep, ploidy,
                              max_alleles, device=device)

        self.local.upem_optimize_device = upem
        return self

    def __exit__(self, *exc):
        self.local.upem_optimize_device = self._upem


class SyncCheck:
    """While active, every sweep level's launch (`_sweep_launch`) runs
    under torch.cuda.set_sync_debug_mode("error"), so any host wait in it
    raises, and every level's pull (`_sweep_pull`) counts its host
    waits: CUDA event synchronizations plus any synchronizing call
    PyTorch reports (sync debug mode "warn")."""

    def __init__(self):
        from floria_tpu_torch.phase import local

        self.local = local
        self.pull_waits = []
        self._events = 0

    def __enter__(self):
        self._launch = self.local._sweep_launch
        self._pull = self.local._sweep_pull
        self._sync = torch.cuda.Event.synchronize

        def sync(ev):
            self._events += 1
            return self._sync(ev)

        def launch(*args, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return self._launch(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)

        def pull(pending):
            n0 = self._events
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = self._pull(pending)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            self.pull_waits.append(self._events - n0 + sum(
                "synchroniz" in str(w.message) for w in caught))
            return out

        torch.cuda.Event.synchronize = sync
        self.local._sweep_launch, self.local._sweep_pull = launch, pull
        return self

    def __exit__(self, *exc):
        torch.cuda.Event.synchronize = self._sync
        self.local._sweep_launch = self._launch
        self.local._sweep_pull = self._pull

    def summary(self):
        return {"levels": len(self.pull_waits), "launch_host_waits": 0,
                "pull_host_waits_per_level": self.pull_waits}


def run_cli(sim_dir, out_dir, device="cuda:0", extra=()):
    from floria_tpu_torch import cli

    cli.main(["-b", os.path.join(sim_dir, "sim.bam"),
              "-v", os.path.join(sim_dir, "sim.vcf"),
              "-r", os.path.join(sim_dir, "sim.fa"),
              "-o", out_dir, "--overwrite", "--device", device, *extra])


def _tree(root):
    out = []
    for d, _dirs, files in os.walk(root):
        for f in files:
            if f != "cmd.log":
                out.append(os.path.relpath(os.path.join(d, f), root))
    return sorted(out)


def assert_same_tree(a, b, what):
    files = _tree(a)
    if files != _tree(b):
        raise AssertionError(f"{what}: output files differ: {files} vs "
                             f"{_tree(b)}")
    for f in files:
        if not filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                           shallow=False):
            raise AssertionError(f"{what}: {f} differs")


class DispatchRecorder:
    """Keeps the inputs and outputs of the sweep's beam calls (K1) and of
    the realignment's device NW calls (K5) while active, so the kernels
    can be checked and timed at the main path's own dispatches."""

    def __init__(self):
        from floria_tpu_torch.kernels import beam, realign

        self.module = beam
        self.realign = realign
        self.beam = []
        self.nw = []

    def __enter__(self):
        self._beam = self.module.beam_search_traceback
        self._nw = self.realign.nw_best

        def beam(alleles, weights, nr, ep, nparts, P, W, **kw):
            out = self._beam(alleles, weights, nr, ep, nparts, P, W, **kw)
            self.beam.append(((alleles, weights, nr, ep, nparts), P, W,
                              kw, out))
            return out

        def nw(*args):
            out = self._nw(*args)
            self.nw.append((args, out))
            return out

        self.module.beam_search_traceback = beam
        self.realign.nw_best = nw
        return self

    def __exit__(self, *exc):
        self.module.beam_search_traceback = self._beam
        self.realign.nw_best = self._nw


def device_busy_s(prof) -> float:
    """Union of the traced device intervals (kernels, copies, sets)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy * 1e-6


def e2e_ecoli2(tmp):
    """The port's CLI on bench.py's ecoli2 community: first, second
    (every sweep level's launch under sync debug mode "error", its
    pull's host waits counted; its launches exactly one K1 and one K6
    climb per dispatch, one K6 MEC per fused level-2 dispatch, no K4),
    traced and CPU runs, byte-equal. Returns (launches of the first run,
    the second run's recorded dispatches, its recorded climbs, {run:
    record})."""
    from floria_tpu_torch import timing
    from floria_tpu_torch.kernels import _build
    from floria_tpu_torch.sim.simulate import SimConfig, simulate

    cfg = SimConfig(**ECOLI2)
    sim_dir = os.path.join(tmp, "ecoli2")
    t0 = time.time()
    simulate(cfg, sim_dir)
    emit({"phase": "e2e", "config": "ecoli2", "simulate_s":
          time.time() - t0})
    out_dir = os.path.join(tmp, "ecoli2_out")
    contig_dir = os.path.join(out_dir, cfg.contig_name)

    def one_run(label, device="cuda:0"):
        t0 = time.perf_counter()
        run_cli(sim_dir, out_dir, device=device)
        if device != "cpu":
            torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
        for name in (f"{cfg.contig_name}.haplosets",
                     f"{cfg.contig_name}.vartigs", "vartig_info.txt"):
            p = os.path.join(contig_dir, name)
            if not os.path.exists(p) or os.path.getsize(p) == 0:
                raise AssertionError(f"ecoli2 {label}: output {name} "
                                     "missing or empty")
        with open(os.path.join(contig_dir,
                               f"{cfg.contig_name}.haplosets")) as fh:
            n_reads = sum(1 for line in fh if not line.startswith(">"))
        kept = out_dir + "_" + label
        shutil.move(out_dir, kept)
        rec = {"phase": "e2e", "config": "ecoli2", "run": label,
               "device": device, "e2e_s": e2e_s,
               "haploset_reads": n_reads, "reads_per_s": n_reads / e2e_s,
               "stages_s": dict(timing.STAGE_TIMES)}
        return rec, kept

    torch.cuda.reset_peak_memory_stats()
    _build.LAUNCHES.clear()
    rec, first = one_run("first")
    launches = dict(_build.LAUNCHES)
    rec["launches"] = launches
    rec["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    emit(rec)
    assert_launches("ecoli2 first run", launches)
    if launches.get("nw_best", 0) <= 0:
        raise AssertionError(f"the ecoli2 run launched no K5: {launches}")
    recs = {"first": rec}

    _build.LAUNCHES.clear()
    with DispatchRecorder() as recorder, SweepCounter() as counter, \
            ClimbRecorder() as climbs, SyncCheck() as sync:
        rec, second = one_run("second")
    rec["launches"] = dict(_build.LAUNCHES)
    rec["sync_check"] = sync.summary()
    rec.update(counter.summary())
    emit(rec)
    assert_launches("ecoli2 second run", rec["launches"],
                    counter.expected_launches())
    if {k: v for k, v in rec["launches"].items() if v} != \
            {k: v for k, v in launches.items() if v}:
        raise AssertionError(f"ecoli2: the second run launched "
                             f"{rec['launches']}, the first {launches}")
    recs["second"] = rec
    assert_same_tree(first, second, "ecoli2 second run")
    if len(recorder.beam) != launches["beam_scan"]:
        raise AssertionError(f"{len(recorder.beam)} beam dispatches in "
                             f"the second run, {launches} in the first")
    if len(recorder.nw) != launches["nw_best"]:
        raise AssertionError(f"{len(recorder.nw)} NW partitions in the "
                             f"second run, {launches} in the first")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        rec, traced = one_run("traced")
    busy = device_busy_s(prof)
    if busy <= 0.0:
        raise AssertionError("the traced ecoli2 run shows no device time")
    rec["device_busy_s"] = busy
    rec["device_idle_share"] = 1.0 - busy / rec["e2e_s"]
    emit(rec)
    recs["traced"] = rec
    assert_same_tree(first, traced, "ecoli2 traced run")

    rec, cpu = one_run("cpu", device="cpu")
    emit(rec)
    assert_same_tree(first, cpu, "ecoli2 card run against the CPU run")
    emit({"phase": "e2e", "config": "ecoli2", "byte_equal":
          ["second", "traced", "cpu"], "files": len(_tree(first))})
    return launches, recorder, climbs.climbs, recs


def check_dispatches(dev, recorder, climbs, sweep_later):
    """K1, K4 and K6 against their plain versions at the main path's
    largest recorded beam dispatch: as dispatched, and on the same blocks
    at the next ploidy (the dispatch a further sweep level gives them).
    K4 runs on the first UPEM iteration's input (the beam's
    assignments), and on the later UPEM iterations that apply moves: the
    launch route's on the main path's own climbs, recorded in phase 4
    (`climbs`), on the next-ploidy dispatch, and `sweep_later` (phase
    3's loop on the kernel sweep); the one that moves the most reads is
    timed. K6 runs at the climb's inputs: its modes (check_eval) and its
    climb kernel against upem_climb_plain (check_climb), and the whole
    climb is timed against the launch route and the host loop
    (climb_ab); K6's ploidy-1 MEC (check_mec1) at the dispatch as made.
    Returns ([{"k1": (err, kernel_s, plain_s, bound), "k4": ..., "k6":
    ..., "climb": (err, kernel_s, plain_s, bound, record), "climb_ab":
    record, "mec1": check_mec1's result (first only)}] for the dispatch
    as made first and at the next ploidy, check_later_moves' result)."""
    (al, wt, nr, ep, npt), P0, W, kw, (_res, asg) = max(
        recorder.beam, key=lambda b: b[0][0].shape[0])
    A = kw["max_alleles"]
    out = []
    for P in (P0, P0 + 1):
        label = f"ecoli2 dispatch P={P}"
        if P != P0:
            label += " (same blocks)"
            npt = torch.full_like(npt, P)
        k1_err, k_s, p_s, ups, k1_bnd = check_beam(
            dev, al, wt, nr, ep, npt, P, W=W, A=A,
            window=kw["window"], label=label, timing=True)
        if P == P0 and not torch.equal(asg, ups[4]):
            raise AssertionError(f"{label}: K1 differs from its own "
                                 "main-path result")
        k4 = check_first_moves(ups, P, A, label=label + " iteration 0")
        out.append({"k1": (k1_err, k_s, p_s, k1_bnd), "k4": k4,
                    "k6": check_eval(ups, P, A, label, timing=True),
                    "climb": check_climb(ups, P, A, label, timing=True),
                    "climb_ab": climb_ab(ups, P, A, label)})
        if P == P0:
            out[-1]["mec1"] = check_mec1(ups, A, f"ecoli2 dispatch "
                                         f"(G={al.shape[0]}) P=1")

    with MovesRecorder() as moves:
        for P, (c_al, c_wt, c_nr, c_ep, c_asg), c_A in climbs:
            climb_launch_route(c_al, c_wt, c_asg, c_nr, c_ep, P, c_A)
    main_later = moves.later_with_moves("ecoli2 main path")
    n_next, next_later = upem_loop_moves(
        ups, P0 + 1, A, f"ecoli2 dispatch P={P0 + 1} (same blocks)")
    emit({"phase": "dispatch", "kernel": "upem_moves",
          "main_path_climbs": len(climbs),
          "launch_route_calls": len(moves.calls),
          "main_path_later_with_moves": len(main_later),
          f"p{P0 + 1}_loop_calls": n_next,
          f"p{P0 + 1}_loop_later_with_moves": len(next_later),
          "sweep_loop_later_with_moves": len(sweep_later)})
    return out, check_later_moves(main_later + next_later + sweep_later)


def check_nw(dev, case, label, timing=False):
    """K5 against its plain version on the card (best alleles and every
    allele's score) and against the native C++ Gotoh on the host (best
    alleles), bitwise. `case` = (q_packed, si, nal, ref_tab, al_tab,
    a_max), tensors on the card. Returns (max_abs_err, kernel_s,
    plain_s, best, (bound_ms, bound_by))."""
    from floria_tpu_torch.kernels import realign as tr

    q, si, nal, ref_tab, al_tab, a_max = case
    n = q.shape[0]
    scores = torch.empty((n, a_max), dtype=torch.int32, device=dev)
    got = tr.nw_best_cuda(q, si, nal, ref_tab, al_tab, a_max, scores=scores)
    ref = tr.nw_best_plain(q, si, nal, ref_tab, al_tab, a_max)
    ref_sc = tr.nw_allele_scores_plain(q, si, nal, ref_tab, al_tab, a_max)
    err = max(max_abs_diff(ref, got), max_abs_diff(ref_sc, scores))
    if err != 0.0 or not (torch.equal(ref, got)
                          and torch.equal(ref_sc, scores)):
        raise AssertionError(f"K5 {label} differs from the plain NW "
                             f"(max abs {err})")
    host = [x.cpu().numpy() for x in (q, si, nal, ref_tab, al_tab)]
    cpp = tr.native.nw_batch(*host)
    if not np.array_equal(cpp, got.cpu().numpy()):
        raise AssertionError(f"K5 {label} differs from the native C++ "
                             "Gotoh")
    bnd = k5_bound(q, si, nal, ref_tab, al_tab, a_max)
    rec = {"phase": "realign", "kernel": "nw_best", "case": label, "N": n,
           "T": int(ref_tab.shape[0]), "A": int(al_tab.shape[1]),
           "a_max": a_max, "nal": torch.unique(nal).tolist(),
           "calls_nonzero": int((got != 0).sum()),
           "plain_bitwise_equal": True, "cpp_bitwise_equal": True,
           "bound_ms": bnd[0], "bound_by": bnd[1]}
    k_s = p_s = None
    if timing:
        k_s = timed(lambda: tr.nw_best_cuda(q, si, nal, ref_tab, al_tab,
                                            a_max))
        p_s = timed(lambda: tr.nw_best_plain(q, si, nal, ref_tab, al_tab,
                                             a_max))
        rec.update(
            kernel_ms=k_s * 1e3, plain_ms=p_s * 1e3,
            kernel_device_ms=kernel_device_ms(
                lambda: tr.nw_best_cuda(q, si, nal, ref_tab, al_tab, a_max),
                "nw_best_kernel"),
            cpp_host_ms=timed(lambda: tr.native.nw_batch(*host)) * 1e3,
            cpp_host_threads=tr.native.threads.num_threads(),
            job_upload_ms=timed(lambda: [torch.from_numpy(x).to(dev)
                                         for x in host[:3]]) * 1e3)
        AB_CASES["nw_best"][label] = (
            *(torch.from_numpy(x) for x in host), a_max)
    emit(rec)
    return err, k_s, p_s, got, bnd


def check_realign(dev, recorder):
    """K5 at the main path's own NW partitions, recorded in phase 4 (the
    first one timed), and on adversarial windows at 4 alleles. Returns
    (max_abs_err, kernel_s, plain_s, bound) of the first partition."""
    out = None
    err = 0.0
    for i, (args, main_best) in enumerate(recorder.nw):
        e, k_s, p_s, got, bnd = check_nw(
            dev, args, f"ecoli2 partition {i}", timing=out is None)
        if not torch.equal(got, main_best):
            raise AssertionError(f"K5 ecoli2 partition {i} differs from "
                                 "its own main-path result")
        err = max(err, e)
        if out is None:
            out = (k_s, p_s, bnd)
    case = [torch.from_numpy(x).to(dev)
            for x in nw_case(n=20_011, T=997, A=4, seed=5)]
    err = max(err, check_nw(dev, (*case, 4), "adversarial A=4")[0])
    return (err, *out)


def parity_long3(tmp):
    """The port's CLI on long3 against the oracle pipeline's bytes
    (tests/data/long3_oracle.json, written and checked against
    tests/oracle_pipeline.py by tests/test_torch_pipeline.py)."""
    from floria_tpu_torch.sim.simulate import SimConfig, simulate

    with open(GOLDEN_LONG3) as fh:
        golden = json.load(fh)
    sim_dir = os.path.join(tmp, "long3")
    simulate(SimConfig(**golden["sim_config"]), sim_dir)
    for name, want in golden["inputs_sha256"].items():
        with open(os.path.join(sim_dir, name), "rb") as fh:
            if hashlib.sha256(fh.read()).hexdigest() != want:
                raise AssertionError(f"simulated long3 {name} differs "
                                     "from the golden record's input")
    out_dir = os.path.join(tmp, "long3_out")
    run_cli(sim_dir, out_dir, extra=golden["cli_args"])
    contig = golden["sim_config"]["contig_name"]
    cdir = os.path.join(out_dir, contig)
    names = {"vartigs": f"{contig}.vartigs",
             "haplosets": f"{contig}.haplosets", "info": "vartig_info.txt"}
    for key, name in names.items():
        with open(os.path.join(cdir, name)) as fh:
            if fh.read().replace(cdir, "<cdir>") != golden["outputs"][key]:
                raise AssertionError(f"long3 {name} differs from the "
                                     "oracle")
    with open(os.path.join(out_dir, "contig_ploidy_info.tsv")) as fh:
        if fh.read().splitlines()[-1] + "\n" != golden["outputs"]["ploidy"]:
            raise AssertionError("long3 ploidy row differs from the oracle")
    emit({"phase": "parity", "config": "long3",
          "byte_equal": sorted(golden["outputs"])})


def load_north_star():
    with open(GOLDEN_NORTH_STAR) as fh:
        return json.load(fh)


def _sha256(path, out_dir=None):
    """sha256 of a file's bytes, with `out_dir` (the run's -o, which the
    outputs embed) written as OUT_MARK."""
    with open(path, "rb") as fh:
        data = fh.read()
    if out_dir is not None:
        data = data.replace(out_dir.encode(), OUT_MARK.encode())
    return hashlib.sha256(data).hexdigest()


def output_sha256(root, out_dir):
    """{file: sha256} of the output tree at `root` (cmd.log left out),
    written by a run whose -o was `out_dir`."""
    return {f: _sha256(os.path.join(root, f), out_dir) for f in _tree(root)}


def simulate_case(entry, sim_dir):
    """Simulates a golden entry's community into `sim_dir`, holds its
    inputs to the entry's hashes and returns its SimTruth."""
    from floria_tpu_torch.sim.simulate import (SimConfig, simulate,
                                               simulate_hybrid)

    cfg = SimConfig(**entry["sim_config"])
    short = entry.get("short_coverage_per_strain")
    truth = (simulate(cfg, sim_dir) if short is None else simulate_hybrid(
        cfg, sim_dir, short_coverage_per_strain=short))
    for name, want in entry["inputs_sha256"].items():
        if _sha256(os.path.join(sim_dir, name)) != want:
            raise AssertionError(f"simulated {name} of {cfg} differs from "
                                 "the golden record's input")
    return truth


def case_args(entry, sim_dir):
    """The entry's CLI flags (besides -b/-v/-r/-o) for inputs in
    `sim_dir`."""
    return [a.replace(SIM_MARK, sim_dir) for a in entry["cli_args"]]


def assert_golden_outputs(name, out_dir, want):
    """Raises unless the output tree of a run at `out_dir` hashes to
    `want`, file by file."""
    got = output_sha256(out_dir, out_dir)
    if sorted(got) != sorted(want):
        raise AssertionError(f"{name}: output files {sorted(got)}, the JAX "
                             f"CLI wrote {sorted(want)}")
    for f, h in sorted(want.items()):
        if got[f] != h:
            raise AssertionError(f"{name}: {f} differs from the JAX CLI's")


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_golden_case(name, entry, tmp, device="cuda:0"):
    """The port's CLI on one config of tests/data/north_star_golden.json,
    every output file held to the JAX CLI's hash. Returns (record,
    sim_dir, out_dir, truth)."""
    from floria_tpu_torch.kernels import _build

    sim_dir = os.path.join(tmp, name)
    truth = simulate_case(entry, sim_dir)
    out_dir = os.path.join(tmp, name + "_out")
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    run_cli(sim_dir, out_dir, device=device,
            extra=case_args(entry, sim_dir))
    _sync(device)
    seconds = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    assert_golden_outputs(name, out_dir, entry["outputs_sha256"])
    rec = {"phase": "north_star", "config": name, "device": str(device),
           "e2e_s": seconds, "launches": launches,
           "files_equal_to_jax": len(entry["outputs_sha256"])}
    return rec, sim_dir, out_dir, truth


def north_star_phase(tmp, device="cuda:0"):
    """Phase north_star: the port's CLI on the round's small configs
    (the JAX package's oracle configs and fuzz seeds), each output held
    to the JAX CLI's bytes. Returns {config: (sim_dir, out_dir)}."""
    golden = load_north_star()["configs"]
    dirs = {}
    for name, entry in golden.items():
        if name == "config4":
            continue
        rec, sim_dir, out_dir, _truth = run_golden_case(name, entry, tmp,
                                                        device)
        emit(rec)
        dirs[name] = (sim_dir, out_dir)
    return dirs


class SweepCounter:
    """While active, counts the sweep's beam dispatches (K1) by level
    (the dispatch's ploidy) with their blocks, and its climbs with the
    instances each climb moved. It keeps no tensor beyond a count per
    climb and adds no device sync: the counts stay on the device until
    summary()."""

    def __init__(self):
        from floria_tpu_torch.kernels import beam
        from floria_tpu_torch.phase import local

        self.beam, self.local = beam, local
        self.levels, self.blocks, self.moved = {}, {}, []

    def __enter__(self):
        self._beam = self.beam.beam_search_traceback
        self._upem = self.local.upem_optimize_device

        def beam(alleles, weights, nr, ep, nparts, P, W, **kw):
            self.levels[P] = self.levels.get(P, 0) + 1
            self.blocks[P] = self.blocks.get(P, 0) + int(alleles.shape[0])
            return self._beam(alleles, weights, nr, ep, nparts, P, W, **kw)

        def upem(alleles, weights, assign0, *args, **kw):
            out = self._upem(alleles, weights, assign0, *args, **kw)
            self.moved.append((out[0] != assign0.to(out[0].dtype))
                              .any(dim=1).sum())
            return out

        self.beam.beam_search_traceback = beam
        self.local.upem_optimize_device = upem
        return self

    def __exit__(self, *exc):
        self.beam.beam_search_traceback = self._beam
        self.local.upem_optimize_device = self._upem

    def summary(self):
        return {"dispatches_by_level": {str(p): n for p, n in
                                        sorted(self.levels.items())},
                "blocks_by_level": {str(p): n for p, n in
                                    sorted(self.blocks.items())},
                "highest_level": max(self.levels, default=None),
                "climbs": len(self.moved),
                "instances_moved": int(torch.stack(self.moved).sum())
                if self.moved else 0}

    def expected_launches(self):
        """The kernel launches of the counted sweep on one card: one K1
        and one K6 climb kernel per dispatch, one K6 evaluation kernel
        (the ploidy-1 MEC) per fused level-2 dispatch, and no K4."""
        dispatches = sum(self.levels.values())
        return {"beam_scan": dispatches, "upem_moves": 0,
                "upem_climb": dispatches,
                "upem_eval": self.levels.get(2, 0)}


def assert_launches(what, launches, want=None):
    """K1 and K6's climb kernel launched and K4 not (its body runs inside
    the climb kernel); with `want`, exactly those counts (K6's evaluation
    kernel too)."""
    got = {k: launches.get(k, 0) for k in ("beam_scan", "upem_moves",
                                           "upem_climb", "upem_eval")}
    if want is not None and got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")
    if got["beam_scan"] <= 0 or got["upem_climb"] <= 0 \
            or got["upem_moves"] != 0:
        raise AssertionError(f"{what}: launches {launches}: K1 and K6's "
                             "climb kernel must launch, K4 not")


def config4_phase(tmp, device="cuda:0"):
    """Phase config4: BASELINE.json config #4, the 5-strain community
    (300 kbp, 9,000 SNPs, `-p 6 -s 3`) at full size. The CLI runs in
    this process first, then second and, on a card, traced, each held to
    the JAX CLI's bytes. The second run counts the sweep's beam
    dispatches per level and its climbs with the instances they moved,
    records every UPEM climb's inputs, and on a card runs every level's
    launch under sync debug mode "error" and counts each pull's host
    waits; on a card a climb is one launch of K6's climb kernel, so it
    launches once per dispatch, K6's evaluation kernel once per fused
    level-2 dispatch (its level-1 MEC), and K4 never. The traced run
    gives the card's busy share.
    The outputs are scored against the simulation's truth and must give
    the golden record's evaluation. Returns (evaluation, the recorded
    climbs, {run: record})."""
    from floria_tpu_torch import timing
    from floria_tpu_torch.kernels import _build
    from floria_tpu_torch.sim.evaluate import (evaluate_haplosets,
                                               evaluate_vartigs)
    from torch.profiler import ProfilerActivity, profile

    entry = load_north_star()["configs"]["config4"]
    contig = entry["sim_config"]["contig_name"]
    sim_dir = os.path.join(tmp, "config4")
    t0 = time.time()
    truth = simulate_case(entry, sim_dir)
    n_reads = len(truth.read_strains)
    emit({"phase": "config4", "simulate_s": time.time() - t0,
          "reads": n_reads})
    out_dir = os.path.join(tmp, "config4_out")
    on_card = torch.device(device).type == "cuda"
    counter, climbs, sync = SweepCounter(), ClimbRecorder(), SyncCheck()
    recs = {}
    for label in ("first", "second", "traced") if on_card else ("first",
                                                                 "second"):
        # The first run is left uninstrumented; the runs are byte-equal.
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        _build.LAUNCHES.clear()
        with contextlib.ExitStack() as stack:
            if label == "second":
                stack.enter_context(counter)
                stack.enter_context(climbs)
                if on_card:
                    stack.enter_context(sync)
            prof = (stack.enter_context(profile(
                activities=[ProfilerActivity.CUDA]))
                if label == "traced" else None)
            t0 = time.perf_counter()
            run_cli(sim_dir, out_dir, device=device,
                    extra=case_args(entry, sim_dir))
            _sync(device)
            e2e_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        assert_golden_outputs(f"config4 {label} run", out_dir,
                              entry["outputs_sha256"])
        rec = {"phase": "config4", "run": label, "device": str(device),
               "e2e_s": e2e_s, "reads": n_reads,
               "reads_per_s": n_reads / e2e_s, "launches": launches,
               "stages_s": dict(timing.STAGE_TIMES),
               "files_equal_to_jax": len(entry["outputs_sha256"])}
        if on_card:
            rec["peak_device_bytes"] = torch.cuda.max_memory_allocated()
            assert_launches(f"config4 {label} run", launches)
        if prof is not None:
            busy = device_busy_s(prof)
            if busy <= 0.0:
                raise AssertionError("the traced config4 run shows no "
                                     "device time")
            rec["device_busy_s"] = busy
            rec["device_idle_share"] = 1.0 - busy / e2e_s
        if label == "second":
            rec.update(counter.summary())
            if on_card:
                rec["sync_check"] = sync.summary()
                assert_launches("config4 second run", launches,
                                counter.expected_launches())
            if rec["instances_moved"] <= 0:
                raise AssertionError("config4: no climb moved a read")
        emit(rec)
        recs[label] = rec
        kept = out_dir + "_" + label
        shutil.move(out_dir, kept)
    cdir = os.path.join(kept, contig)
    got = {"vartigs": dataclasses.asdict(evaluate_vartigs(
               os.path.join(cdir, f"{contig}.vartigs"), truth)),
           "haplosets": dataclasses.asdict(evaluate_haplosets(
               os.path.join(cdir, f"{contig}.haplosets"), truth))}
    emit({"phase": "config4", "evaluation": got,
          "golden_evaluation": entry["evaluation"]})
    if got != entry["evaluation"]:
        raise AssertionError(f"config4 evaluation {got} differs from the "
                             f"golden record's {entry['evaluation']}")
    return got, climbs.climbs, recs


def upem_climb_phase(climbs):
    """Phase upem_climb: K6 at every UPEM climb the config4 run recorded,
    its climb kernel against upem_climb_plain (check_climb) and its modes
    against their plain versions (check_eval: init, step, mec); at the
    largest dispatch of each sweep level both timed and the whole climb
    timed against the launch route and the host loop (climb_ab). Returns
    ({level: (check_eval's result, check_climb's, climb_ab's record)} at
    those dispatches, max_abs_err over the evaluation kernel's checks and
    over the climb kernel's)."""
    largest = {}
    for i, (P, ups, A) in enumerate(climbs):
        if P not in largest or ups[0].shape[0] > climbs[largest[P]][1][0] \
                .shape[0]:
            largest[P] = i
    err, climb_err, out = 0.0, 0.0, {}
    for i, (P, ups, A) in enumerate(climbs):
        label = f"config4 level {P} dispatch {i}"
        timing = largest[P] == i
        res = check_eval(ups, P, A, label, timing=timing)
        climb = check_climb(ups, P, A, label, timing=timing)
        err, climb_err = max(err, res[0]), max(climb_err, climb[0])
        if timing:
            out[P] = (res, climb, climb_ab(ups, P, A, label))
    emit({"phase": "upem_climb", "config": "config4",
          "climbs_checked": len(climbs), "levels": sorted(out),
          "max_abs_err": max(err, climb_err)})
    return out, err, climb_err


def tools_outputs(sim_dir, haplosets, contig, dest, device="cuda:0"):
    """The port's tools on one simulated community: vartig-dump, the
    haplotagged BAM of `haplosets` at HAPQ >= 0, and the frags.txt of the
    contig's fragments as get_frags_from_bam returns them (realigned
    against the FASTA on `device`), read back. Returns {output: sha256},
    each file's bytes with its own path written as OUT_MARK; raises
    unless the frags.txt reads back the fragments' values."""
    from floria_tpu_torch import vartig_dump
    from floria_tpu_torch.ingest.bam import BamFile
    from floria_tpu_torch.ingest.fasta import FastaFile
    from floria_tpu_torch.ingest.fragfile import (read_frags_file,
                                                  write_frags_file)
    from floria_tpu_torch.ingest.fragments import get_frags_from_bam
    from floria_tpu_torch.ingest.vcf import read_vcf
    from floria_tpu_torch.options import Options
    from floria_tpu_torch.out.haplotag import (haplotag_records,
                                               read_haploset,
                                               write_bam_records)
    from floria_tpu_torch.pipeline import open_bam

    bam, vcf = (os.path.join(sim_dir, f) for f in ("sim.bam", "sim.vcf"))
    os.makedirs(dest, exist_ok=True)
    paths = {k: os.path.join(dest, k) for k in
             ("vartig_dump.txt", "haplotagged.bam", "frags.txt")}
    vartig_dump.main(["-b", bam, "-v", vcf, "-o", paths["vartig_dump.txt"]])

    name_to_part = {}
    for i, names in read_haploset(haplosets, 0).items():
        for n in names:
            name_to_part[n] = i
    template = BamFile(bam)
    write_bam_records(paths["haplotagged.bam"], template,
                      haplotag_records(template, contig, name_to_part))

    cv = read_vcf(vcf, [contig]).get(contig)
    ref_seq = FastaFile(os.path.join(sim_dir, "sim.fa")).fetch(contig)
    frags, _ = get_frags_from_bam(open_bam(bam), None, cv, Options(),
                                  ref_seq, contig, device=device)
    write_frags_file(frags, paths["frags.txt"])
    back = read_frags_file(paths["frags.txt"])["frag_contig"]
    if len(back) != len(frags) or any(
            g.seq_dict != dict(f.seq_dict) or g.qual_dict != dict(f.qual_dict)
            for f, g in zip(frags, back)):
        raise AssertionError("frags.txt does not read back the fragments' "
                             "alleles and quals")
    out = {k: _sha256(p, p) for k, p in paths.items()}
    out["tagged_reads"] = len(name_to_part)
    out["frags"] = len(frags)
    return out


def tools_phase(tmp, sim_dir, out_dir, device="cuda:0"):
    """Phase tools: vartig-dump, haplotagging and the frags.txt round
    trip on long3 (the inputs and outputs of phase north_star), each
    output held to the JAX functions' hash in the golden record."""
    golden = load_north_star()
    want = golden["tools"]
    contig = golden["configs"]["long3"]["sim_config"]["contig_name"]
    got = tools_outputs(sim_dir, os.path.join(
        out_dir, contig, f"{contig}.haplosets"), contig,
        os.path.join(tmp, "tools"), device)
    if got != want:
        raise AssertionError(f"tools: {got} differs from the JAX "
                             f"functions' {want}")
    emit({"phase": "tools", "config": "long3", "outputs_equal_to_jax":
          sorted(got)})


def workload_blocks(G=8, R=320, S=2048):
    """make_workload's instances as the sweep's (key, BlockTensor)
    blocks. The sweep takes phred quals, so each weight becomes its qual
    (1 - 10^(-q/10) inverted) and then the table's weight of that qual."""
    from floria_tpu_torch import state
    from floria_tpu_torch.kernels.blocktensor import BlockTensor

    alleles, weights, _nr, _eps = make_workload(G, R, S)
    table = state.phred_table()
    cov = alleles >= 0
    with np.errstate(divide="ignore"):
        q = np.rint(-10.0 * np.log10(1.0 - weights.astype(np.float64)))
    quals = np.where(cov, q, 0).astype(np.uint8)
    if not np.allclose(table[quals], weights, rtol=0, atol=1e-6):
        raise AssertionError("make_workload's weights are not phred "
                             "weights")
    return [(g, BlockTensor(
        frag_ids=np.arange(R, dtype=np.int64), lo=1, num_sites=S,
        num_reads=R, alleles=alleles[g], weights=table[quals[g]],
        snp_range=(1, S), quals=quals[g])) for g in range(G)]


def _assert_sweeps_equal(label, a, b):
    for got, want, what in zip(a, b, ("chosen", "mec", "expected")):
        if set(got) != set(want):
            raise AssertionError(f"{label}: {what} keys differ")
        for k in want:
            x, y = got[k], want[k]
            if what == "chosen":
                if x[0] != y[0] or not np.array_equal(x[1], y[1]):
                    raise AssertionError(f"{label}: block {k} differs")
            elif not np.array_equal(x, y):
                raise AssertionError(f"{label}: {what} of {k} differs")


# One rank of the CLI in its own process: the user's entry point, then
# its launch counts, the seconds of cli.main and its stages, and any jax
# or `floria_tpu` module it loaded.
RANK = r"""
import json, sys, time
sys.path.insert(0, {repo!r})
from floria_tpu_torch import cli, timing
from floria_tpu_torch.kernels import _build
t0 = time.perf_counter()
cli.main(sys.argv[1:])
print("RANK " + json.dumps({{"launches": dict(_build.LAUNCHES),
    "cli_s": time.perf_counter() - t0, "stages_s": dict(timing.STAGE_TIMES),
    "loaded": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "floria_tpu"))
}}))
"""


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(sim_dir, out_dir, nproc, timeout=600):
    """The port's CLI as `nproc` ranks on the card (the coordinator on
    localhost). Returns (wall seconds, [each rank's record: launch
    counts, seconds in cli.main, stage seconds]);
    raises unless every rank exits 0; kills them all on the way out. Each
    rank writes its output to files beside `out_dir` (a rank blocked on
    a full pipe would hold the other at the barrier)."""
    argv = ["-b", os.path.join(sim_dir, "sim.bam"),
            "-v", os.path.join(sim_dir, "sim.vcf"),
            "-r", os.path.join(sim_dir, "sim.fa"), "-o", out_dir,
            "--overwrite", "--device", "cuda",
            "--num-processes", str(nproc),
            "--coordinator", f"127.0.0.1:{_free_port()}"]
    code = RANK.format(repo=REPO)
    logs = [f"{out_dir}.{nproc}.rank{k}" for k in range(nproc)]
    t0 = time.perf_counter()
    procs = []
    try:
        for k, log in enumerate(logs):
            with open(log + ".out", "w") as out, \
                    open(log + ".err", "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", code, *argv, "--process-id",
                     str(k)], stdout=out, stderr=err))
        for p in procs:
            p.wait(timeout=max(1.0, t0 + timeout - time.perf_counter()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    ranks = []
    for k, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            with open(log + ".err") as fh:
                raise AssertionError(f"rank {k} of {nproc} exited "
                                     f"{p.returncode}:\n{fh.read()[-4000:]}")
        with open(log + ".out") as fh:
            rec = json.loads([ln for ln in fh.read().splitlines()
                              if ln.startswith("RANK ")][-1][5:])
        if rec.pop("loaded"):
            raise AssertionError(f"rank {k} loaded jax or floria_tpu")
        ranks.append(rec)
    return wall, ranks


def _shared_tree(root):
    """Output files without cmd.log and the ranks' own summary TSVs (the
    merge's inputs)."""
    return [f for f in _tree(root)
            if not (f.startswith("contig_ploidy_info.")
                    and f.count(".") == 2)]


def parallel_phase(dev, recorder, tmp):
    """Phase 8: the parallel layer, two shards on the one card or one
    shard per card of a machine with more; the unsharded references run
    on `dev` (cuda:0) alone. Returns (the sharded K1 record, the
    one-process multi500 run's launch counts)."""
    from floria_tpu_torch.entry import dryrun_multichip
    from floria_tpu_torch.kernels import _build
    from floria_tpu_torch.kernels import beam as tb
    from floria_tpu_torch.options import Options
    from floria_tpu_torch.parallel.mesh import beam_search_sharded
    from floria_tpu_torch.phase.local import adaptive_sweep
    from floria_tpu_torch.sim.simulate import simulate_multi

    n_cards = torch.cuda.device_count()
    mesh = ([torch.device("cuda", i) for i in range(n_cards)]
            if n_cards > 1 else [dev] * 2)

    # (a) K1 through the sharded dispatch at phase 4's largest dispatch.
    (al, wt, nr, ep, npt), P, W, kw, _out = max(
        recorder.beam, key=lambda b: b[0][0].shape[0])
    A, window = kw["max_alleles"], kw["window"]
    al, wt, nr, ep, npt = tb._inputs(al, wt, nr, ep, npt, dev)

    def sharded():
        return beam_search_sharded(mesh, al, wt, nr, ep, npt, P, W,
                                   window=window, max_alleles=A)

    def unsharded():
        res, asg = tb.beam_search_traceback(al, wt, nr, ep, npt, P, W,
                                            max_alleles=A, window=window,
                                            device=dev)
        return type(res)(*(x.cpu().numpy() for x in res)), \
            asg.cpu().numpy()

    _build.LAUNCHES.clear()
    got = sharded()
    launches = dict(_build.LAUNCHES)
    if launches.get("beam_scan", 0) != len(mesh):
        raise AssertionError(f"sharded K1: {launches} launches for "
                             f"{len(mesh)} shards")
    S = al.shape[-1]
    win = S if window <= 0 or window >= S else window
    prep = tb._prepare(al, wt, ep, A, P, win, True)
    plain = tb.beam_scan_plain(al, wt, nr, *prep[:2], npt, *prep[2:], P=P,
                               W=W, A=A, window=win)
    plain = (type(plain)(*(x.cpu().numpy() for x in plain)),
             tb.traceback_batch(plain).cpu().numpy())
    err = 0.0
    for label, ref in (("unsharded K1", unsharded()), ("plain", plain)):
        for name, a, b in zip(ref[0]._fields + ("assign",),
                              (*ref[0], ref[1]), (*got[0], got[1])):
            e = max_abs_diff(torch.from_numpy(a), torch.from_numpy(b))
            if e != 0.0 or not np.array_equal(a, b):
                raise AssertionError(f"sharded K1: {name} differs from "
                                     f"the {label} (max abs {e})")
            err = max(err, e)
    k1 = {"phase": "parallel", "case": "sharded K1 at the ecoli2 dispatch",
          "shards": len(mesh), "cards": len(set(mesh)),
          "G": int(al.shape[0]), "R": int(al.shape[1]),
          "S": int(S), "P": P, "launches": launches["beam_scan"],
          "bitwise_equal": ["unsharded K1", "plain"], "max_abs_err": err,
          "cluster_width_shard": tb.cluster_width(
              -(-int(al.shape[0]) // len(mesh)), mesh[-1]),
          "sharded_ms": timed(sharded) * 1e3,
          "unsharded_ms": timed(unsharded) * 1e3}
    emit(k1)

    # (b) The sweep through the sharded dispatch.
    blocks = workload_blocks()
    opts = Options(epsilon=0.02, max_ploidy=5)
    t0 = time.perf_counter()
    one = adaptive_sweep(blocks, opts, device=dev)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    two = adaptive_sweep(blocks, opts, device=mesh)
    torch.cuda.synchronize()
    two_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    assert_launches("sharded sweep", launches)
    _assert_sweeps_equal("sharded sweep", two, one)
    emit({"phase": "parallel", "case": "sharded sweep (G=8, R=320, "
          "S=2048, ploidies <= 5)", "shards": len(mesh),
          "cards": len(set(mesh)),
          "launches": launches, "ploidies": sorted(
              {int(v[0]) for v in two[0].values()}),
          "equal_to_one_device": True, "sharded_s": two_s,
          "one_device_s": one_s})

    # (c) The dry run.
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    dryrun_multichip(len(mesh), device=mesh)
    dry_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    assert_launches("dryrun_multichip", launches)
    emit({"phase": "parallel", "case": "dryrun_multichip",
          "shards": len(mesh), "launches": launches, "dryrun_s": dry_s})

    # (d) The CLI as two ranks against one process.
    sim_dir = os.path.join(tmp, "multi")
    t0 = time.time()
    simulate_multi(multi_configs(MULTI_CONTIGS), sim_dir)
    emit({"phase": "parallel", "config": f"multi{MULTI_CONTIGS}",
          "contigs": MULTI_CONTIGS, "simulate_s": time.time() - t0})
    out_dir = os.path.join(tmp, "multi_out")
    runs = {}
    for nproc in (1, 2):
        wall, ranks = run_ranks(sim_dir, out_dir, nproc)
        for k, rank in enumerate(ranks):
            assert_launches(f"rank {k} of {nproc}", rank["launches"])
        kept = f"{out_dir}_{nproc}"
        shutil.move(out_dir, kept)
        runs[nproc] = kept
        if nproc == 1:
            one_process_launches = ranks[0]["launches"]
        emit({"phase": "parallel", "config": f"multi{MULTI_CONTIGS}",
              "processes": nproc, "wall_s": wall,
              "rank_launches": [r["launches"] for r in ranks],
              "rank_cli_s": [r["cli_s"] for r in ranks],
              "rank_stages_s": [r["stages_s"] for r in ranks]})
    files = _shared_tree(runs[1])
    if files != _shared_tree(runs[2]):
        raise AssertionError("two ranks wrote other files than one "
                             "process")
    for f in files:
        if not filecmp.cmp(os.path.join(runs[1], f),
                           os.path.join(runs[2], f), shallow=False):
            raise AssertionError(f"two ranks: {f} differs from one "
                                 "process")
    vartigs = sum(f.endswith(".vartigs") for f in files)
    if vartigs != MULTI_CONTIGS:
        raise AssertionError(f"{vartigs} of {MULTI_CONTIGS} contigs phased")
    emit({"phase": "parallel", "config": f"multi{MULTI_CONTIGS}",
          "byte_equal": "2 ranks vs 1 process", "files": len(files)})
    return k1, one_process_launches


def ptxas_report(lines, kernel: str):
    """[{entry, registers, spill_stores, spill_loads}] for each compiled
    entry whose name holds `kernel`, from ptxas's -v lines."""
    out, cur = [], None
    for ln in lines:
        if "entry function" in ln:
            cur = {"entry": ln.split("'")[1]} if kernel in ln else None
            if cur is not None:
                out.append(cur)
        elif cur is not None and "spill" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split()
                    if w.isdigit()]
            cur["spill_stores"], cur["spill_loads"] = nums[1], nums[2]
        elif cur is not None and "registers" in ln:
            cur["registers"] = int(ln.split("Used")[1].split()[0])
    return out


def loaded_reference_modules():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "floria_tpu"))


def main(argv=None) -> None:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ab-inputs", metavar="PATH",
                    help="also save the inputs of every timed K4, K5 and "
                    "climb case (torch.save of {call: {label: args}}) for "
                    "scripts/torch_kernel_parent_ab.py")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, REPO)
    from floria_tpu_torch import native
    from floria_tpu_torch.kernels import _build

    CARD = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": CARD,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device_name": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count()})

    # Both libraries from the checkout's sources: the CUDA kernels (one
    # nvcc per source, in parallel) while g++ builds the native C++.
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=1) as pool:
        native_build = pool.submit(native.get_lib)
        _build.build(force=True)
        _build.get_lib()
        cuda_s = time.time() - t0
        native_build.result()
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if any(w in ln for w in ("entry function", "registers",
                                      "spill"))]
    k6_ptxas = {name: ptxas_report(ptxas, name)
                for name in ("upem_climb_kernel", "upem_eval_kernel")}
    emit({"phase": "build", "seconds": time.time() - t0,
          "cuda_kernels_s": cuda_s, "ptxas": ptxas,
          "climb_kernel": k6_ptxas["upem_climb_kernel"],
          "eval_kernel": k6_ptxas["upem_eval_kernel"]})
    for name, rep in k6_ptxas.items():
        if len(rep) != 4 or any(k["spill_stores"] or k["spill_loads"]
                                for k in rep):
            raise AssertionError(f"{name} spills or is missing from "
                                 f"ptxas's report: {rep}")

    dev = torch.device("cuda", 0)
    alleles, weights, nreads, eps = make_workload(8, 320, 2048)
    nparts = np.array([2, 3, 4, 5, 2, 3, 4, 5], np.int32)
    k1_err, k1_sweep_s, _p_s, ups, k1_sweep_bnd = check_beam(
        dev, alleles, weights, nreads, eps, nparts, 5, label="sweep",
        timing=True, cpu_ref=True)
    for label, case in (("windowed", windowed_case()),
                        ("dedup", dedup_case())):
        *inp, P = case
        k1_err = max(k1_err, check_beam(
            dev, *inp, P, window=384 if label == "windowed" else 0,
            label=label)[0])
    k4_err, k4_sweep_s, _p_s, k4_sweep_bnd = check_first_moves(
        ups, 5, label="sweep")
    _n, sweep_later = upem_loop_moves(ups, 5, 2, "sweep")
    k6_sweep = check_eval(ups, 5, 2, "sweep P=5", timing=True)
    climb_sweep = check_climb(ups, 5, 2, "sweep P=5", timing=True)
    climbs_ab = {"sweep P=5": climb_ab(ups, 5, 2, "sweep P=5")}
    del ups

    with tempfile.TemporaryDirectory(prefix="floria_smoke_") as tmp:
        launches, recorder, climbs, ecoli2_runs = e2e_ecoli2(tmp)
        per_dispatch, k4_later = check_dispatches(dev, recorder, climbs,
                                                  sweep_later)
        k5_err, k5_s, k5_plain_s, k5_bnd = check_realign(dev, recorder)
        del climbs, sweep_later
        parity_long3(tmp)
        north_star = north_star_phase(tmp)
        _eval, climbs, config4_runs = config4_phase(tmp)
        config4_k6, k6_err, climb_err = upem_climb_phase(climbs)
        del climbs
        tools_phase(tmp, *north_star["long3"])
        sharded, multi_launches = parallel_phase(dev, recorder, tmp)
        del recorder

    loaded = loaded_reference_modules()
    if loaded:
        raise AssertionError(f"the port loaded jax or floria_tpu: {loaded}")
    k6_err = max(k6_err, k6_sweep[0], per_dispatch[0]["mec1"][0])
    climb_err = max(climb_err, climb_sweep[0])
    for d in per_dispatch:
        k1_err = max(k1_err, d["k1"][0])
        k4_err = max(k4_err, d["k4"][0])
        k6_err = max(k6_err, d["k6"][0])
        climb_err = max(climb_err, d["climb"][0])
        climbs_ab[d["climb_ab"]["case"]] = d["climb_ab"]
    for P, (_res, _climb, ab) in config4_k6.items():
        climbs_ab[ab["case"]] = ab
    k1_err = max(k1_err, sharded["max_abs_err"])
    k1_s, k1_plain_s, k1_bnd = per_dispatch[0]["k1"][1:]
    k4_s, k4_plain_s, k4_bnd = per_dispatch[0]["k4"][1:]
    k6_s, k6_plain_s, k6_bnd = per_dispatch[0]["climb"][1:4]
    mec1 = per_dispatch[0]["mec1"]
    emit({"phase": "k1_summary", "launches_ecoli2": launches,
          "ecoli2_p2_ms": k1_s * 1e3,
          "ecoli2_p2_two_shards_ms": sharded["sharded_ms"],
          "ecoli2_p3_ms": per_dispatch[1]["k1"][1] * 1e3,
          "sweep_ms": k1_sweep_s * 1e3,
          "bound_ecoli2_p2_ms": k1_bnd[0],
          "bound_ecoli2_p3_ms": per_dispatch[1]["k1"][3][0],
          "bound_sweep_ms": k1_sweep_bnd[0]})
    if k4_later is not None:
        k4_err = max(k4_err, k4_later[0])
    emit({"phase": "k4_summary",
          "launches_ecoli2": launches.get("upem_moves", 0),
          "ecoli2_p2_ms": k4_s * 1e3,
          "ecoli2_p3_ms": per_dispatch[1]["k4"][1] * 1e3,
          "later_iteration": None if k4_later is None else k4_later[4],
          "later_iteration_ms": None if k4_later is None
          else k4_later[1] * 1e3,
          "sweep_ms": k4_sweep_s * 1e3,
          "bound_ecoli2_p2_ms": k4_bnd[0],
          "bound_ecoli2_p3_ms": per_dispatch[1]["k4"][3][0],
          "bound_later_iteration_ms": None if k4_later is None
          else k4_later[3][0],
          "bound_sweep_ms": k4_sweep_bnd[0]})
    runs = {"ecoli2": ecoli2_runs, "config4": config4_runs}
    climb_recs = {"sweep P=5": climb_sweep[4],
                  "ecoli2 P=2": per_dispatch[0]["climb"][4],
                  "ecoli2 P=3": per_dispatch[1]["climb"][4],
                  **{f"config4 level {P}": c[4]
                     for P, (_r, c, _ab) in sorted(config4_k6.items())}}
    eval_recs = {"sweep P=5": k6_sweep, "ecoli2 P=2": per_dispatch[0]["k6"],
                 "ecoli2 P=3": per_dispatch[1]["k6"],
                 **{f"config4 level {P}": r
                    for P, (r, _c, _ab) in sorted(config4_k6.items())}}
    emit({"phase": "k6_summary",
          "launches": {"ecoli2": launches, "multi500": multi_launches,
                       "config4": config4_runs["first"]["launches"]},
          "climb_kernel": {k: {f: r.get(f) for f in (
              "G", "R", "S", "P", "cluster", "shared_memory", "evaluations",
              "rounds_max", "kernel_ms", "kernel_device_ms",
              "kernel_event_ms", "plain_ms", "bound_ms", "pass_bound_ms")}
              for k, r in climb_recs.items()},
          "eval_init_ms": {k: r[1] * 1e3 for k, r in eval_recs.items()},
          "eval_init_device_ms": {k: r[4] for k, r in eval_recs.items()},
          "eval_init_plain_ms": {k: r[2] * 1e3 for k, r in eval_recs.items()
                                 if r[2] is not None},
          "eval_init_bound_ms": {k: r[3][0] for k, r in eval_recs.items()},
          "mec1_ecoli2": {"ms": mec1[1] * 1e3, "device_ms": mec1[4],
                          "plain_ms": mec1[2] * 1e3,
                          "bound_ms": mec1[3][0]},
          "climb_ms": {k: c["climb_ms"] for k, c in climbs_ab.items()},
          "launch_route_ms": {k: c["launch_route_ms"]
                              for k, c in climbs_ab.items()},
          "host_loop_ms": {k: c["host_loop_ms"] for k, c in climbs_ab.items()},
          "climb_enqueue_ms": {k: c["climb_enqueue_ms"]
                               for k, c in climbs_ab.items()},
          "launch_route_enqueue_ms": {k: c["launch_route_enqueue_ms"]
                                      for k, c in climbs_ab.items()},
          "kernel_slower_than_launch_route": sorted(
              k for k, c in climbs_ab.items()
              if c.get("kernel_slower_than_launch_route")),
          "phase_launch_wait_s": {
              f"{cfg} {label}": {k: rec["stages_s"].get(k) for k in (
                  "phasing", "phase.launch", "phase.wait")}
              for cfg, recs in runs.items() for label, rec in recs.items()
              if rec.get("device") != "cpu"},
          "host_waits": {cfg: recs["second"]["sync_check"]
                         for cfg, recs in runs.items()},
          "device_idle_share": {cfg: recs["traced"]["device_idle_share"]
                                for cfg, recs in runs.items()},
          "peak_device_bytes": {cfg: recs["first"]["peak_device_bytes"]
                                for cfg, recs in runs.items()}})
    if args.ab_inputs:
        torch.save(AB_CASES, args.ab_inputs)

    def row(name, source, replaces, err, k_s, p_s, bnd):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches.get(name, 0),
                "max_abs_err": err, "ms": k_s * 1e3,
                "plain_ms": p_s * 1e3, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": None}

    print(json.dumps({"kernels": [
        row("beam_scan", "floria_tpu_torch/csrc/beam_scan.cu",
            "floria_tpu/kernels/beam_pallas.py:427", k1_err, k1_s,
            k1_plain_s, k1_bnd),
        row("upem_moves", "floria_tpu_torch/csrc/upem_moves.cu",
            "floria_tpu/kernels/upem_batch.py:259", k4_err, k4_s,
            k4_plain_s, k4_bnd),
        row("nw_best", "floria_tpu_torch/csrc/nw_best.cu",
            "floria_tpu/kernels/realign.py:94", k5_err, k5_s, k5_plain_s,
            k5_bnd),
        row("upem_climb", "floria_tpu_torch/csrc/upem_eval.cu",
            "floria_tpu/kernels/upem_batch.py:320", climb_err, k6_s,
            k6_plain_s, k6_bnd),
        row("upem_eval", "floria_tpu_torch/csrc/upem_eval.cu",
            "floria_tpu/kernels/upem_batch.py:196", k6_err, mec1[1],
            mec1[2], mec1[3])]}), flush=True)
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
