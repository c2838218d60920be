"""k5.roofline_pct: the least time K5 (the realignment NW,
csrc/nw_best.cu) could take over the window's partitions, as a share of
its device time there. A partition's least time is the larger of its
bytes over the HBM rate and its operations over the scalar rate
(harness/roofline_k5.py), from the program's counts (`h2d_bytes`,
`nw_jobs`, `nw_alleles`) in each `realign.device.nw_best` span; the
device time is that of the kernels whose name holds `nw_best_kernel` in
the profiler's trace. None without a trace, without the counts or
without K5's device time."""

from harness.program_spans import window_records
from harness.roofline_k5 import k5_bound_s


def read(run):
    if run.trace is None:
        return None
    recs = window_records(run)
    spans = [r for r in recs or () if r.name == "realign.device.nw_best"
             and "nw_jobs" in r.counts]
    k5 = sum(s for name, s in run.trace.kernel_s.items()
             if "nw_best_kernel" in name)
    if not spans or k5 <= 0:
        return None
    bound = sum(k5_bound_s(r.counts.get("h2d_bytes", 0), r.counts["nw_jobs"],
                           r.counts.get("nw_alleles", 0)) for r in spans)
    return 100.0 * bound / k5
