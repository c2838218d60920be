"""Single-core reference-semantics END-TO-END baseline on the port.

Runs the port's independent oracle pipeline (`floria_tpu_torch.oracle`:
the dict/loop spec the device path is held to, with the faithful
single-core C++ beam as its inner loop) through ingest -> phasing ->
writers on one contig, pinned to ONE cpu with one host and one torch
thread, and prints one JSON line: the denominator of
`floria_tpu_torch.bench`'s e2e_vs_baseline (the kernel ratio alone
leaves out ingest and the join, floria.rs:204-391: the whole pipeline
is the unit users run). Ingest realigns on the CPU: a partition above
the C++ threshold runs the plain NW (`realign.nw_best_plain`) on that
one thread. The texts the CLI would write go to <sim_dir>/oracle_out in
the CLI's layout. A native library that cannot be built fails the run:
the oracle never times the Python beam in its place.

    python -m floria_tpu_torch.scripts.oracle_e2e_baseline <sim_dir> <contig>

(spawned by `python -m floria_tpu_torch.bench --measure-baseline-e2e`,
with no card visible). On stderr a last line `ORACLE_CHILD {...}` says
whether the process initialised CUDA, which jax or `floria_tpu` modules
it holds (none) and its peak resident memory during the measurement,
in all and per stage (sampled every 50 ms).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

REPORT_PREFIX = "ORACLE_CHILD "


def measure(sim_dir: str, contig: str):
    """The oracle on `contig` of the community in `sim_dir` (sim.bam,
    sim.vcf, sim.fa) with Options' defaults, as the bench's e2e runs it;
    its texts written to <sim_dir>/oracle_out. Returns (the six keys of
    the JAX package's script, {stage: (start, end)} on the
    time.perf_counter clock for ingest, phase and the texts with their
    writing). The native library is built (or its build fails) before
    the clock starts."""
    import torch

    from .. import native
    from ..oracle import run_contig
    from ..oracle.pipeline import write_texts
    from ..options import Options

    native.get_lib()
    opts = Options(bam_file=os.path.join(sim_dir, "sim.bam"),
                   vcf_file=os.path.join(sim_dir, "sim.vcf"),
                   reference_fasta=os.path.join(sim_dir, "sim.fa"))
    t0 = time.perf_counter()
    texts, _phased, seconds = run_contig(opts, contig,
                                         device=torch.device("cpu"))
    write_texts(texts, os.path.join(sim_dir, "oracle_out"), contig)
    t1 = time.perf_counter()
    elapsed = t1 - t0
    t_ingest, t_phase = (t0 + seconds["ingest"],
                         t0 + seconds["ingest"] + seconds["phase"])
    windows = {"ingest": (t0, t_ingest), "phase": (t_ingest, t_phase),
               "texts": (t_phase, t1)}
    # The bench's e2e numerator: haploset members.
    n_reads = sum(1 for line in texts["haplosets"].splitlines()
                  if line and not line.startswith(">"))
    return {
        "baseline_e2e_reads_per_sec": n_reads / elapsed,
        "baseline_e2e_seconds": elapsed,
        "baseline_e2e_reads": n_reads,
        "baseline_e2e_ingest_seconds": seconds["ingest"],
        "baseline_e2e_phase_seconds": seconds["phase"],
        "pinned_single_core": True,
    }, windows


class PeakRss:
    """The resident size /proc/self/statm shows while the block runs,
    read every `interval` seconds by a daemon thread (the rusage maximum
    would include the parent's size at fork, and some kernels' /proc
    has no VmHWM), kept as (time.perf_counter, bytes) samples."""

    def __init__(self, interval=0.05):
        self.interval = interval
        self.samples = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def sample(self):
        try:
            with open("/proc/self/statm") as fh:
                rss = int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
        except (OSError, ValueError, IndexError):
            return
        self.samples.append((time.perf_counter(), rss))

    def peak(self, start=float("-inf"), end=float("inf")):
        """The largest sample taken in [start, end], or None (none taken:
        /proc cannot be read, or the window fell between samples)."""
        return max((rss for t, rss in self.samples if start <= t <= end),
                   default=None)

    def _run(self):
        while not self._stop.wait(self.interval):
            self.sample()

    def __enter__(self):
        self.sample()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.sample()


def child_report(rss: PeakRss, windows) -> dict:
    """What the process touched: CUDA (torch's lazy init), jax or
    `floria_tpu` modules; and its peak resident bytes during the
    measurement, in all and per stage of `windows`."""
    import torch

    return {"cuda_initialized": torch.cuda.is_initialized(),
            "loaded": sorted(m for m in sys.modules if m.split(".")[0]
                             in ("jax", "jaxlib", "floria_tpu")),
            "peak_rss_bytes": rss.peak(),
            "peak_rss_bytes_by_stage": {k: rss.peak(*w)
                                        for k, w in windows.items()}}


def main(argv=None) -> None:
    sim_dir, contig = sys.argv[1:] if argv is None else argv
    # One CPU before torch starts its thread pool, so every stage (numpy,
    # the C++ beam and NW, torch's plain NW) is single-core, like a
    # 1-thread run of the reference.
    try:
        os.sched_setaffinity(0, {sorted(os.sched_getaffinity(0))[0]})
    except (AttributeError, OSError):
        pass
    import torch

    from .. import threads

    threads.set_num_threads(1)
    torch.set_num_threads(1)
    with PeakRss() as rss:
        line, windows = measure(sim_dir, contig)
    print(json.dumps(line), flush=True)
    print(REPORT_PREFIX + json.dumps(child_report(rss, windows)),
          file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
