"""k1.roofline_pct: the least time K1 (the beam scan, csrc/beam_scan.cu)
could take over the traced calls, as a share of its device time there.
The least time of a call is the larger of its bytes over the HBM rate and
its operations over the scalar rate (harness/roofline.py), counted on the
harness's own blocks; the device time is that of the kernels whose name
holds `beam_scan_kernel` in the profiler's trace."""


def read(run):
    bound = run.counters.get("k1.bound_s")
    if run.trace is None or not bound:
        return None
    k1 = sum(s for name, s in run.trace.kernel_s.items()
             if "beam_scan_kernel" in name)
    return 100.0 * bound / k1 if k1 > 0 else None
