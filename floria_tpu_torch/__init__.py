"""floria_tpu_torch — the floria-tpu phasing main path in PyTorch.

A second package beside the JAX reference `floria_tpu`, and independent
of it: it imports neither jax nor any `floria_tpu` module. The host
stages (ingest, fragment finalize, block packing, hap-graph, LP, paths,
post-processing and writers) are the port's own copies of the
reference's numpy modules, and it builds its own copy of the repository's
native C++ library (`native.py`). The device part of the main path (the
adaptive ploidy sweep: beam scan, traceback, UPEM hill-climb, MEC stats;
the realignment NW of large partitions) runs on torch tensors, with
hand-written CUDA kernels for Hopper in `csrc/`. Every count, distance
and score is an exact integer number of 2^-26 weight quanta held in
int64 or f64, so the port is bitwise equal to the reference.

Like the reference's package init, importing the package tunes the
process's memory behaviour for large host buffers (the two functions
below are copies of `floria_tpu/__init__.py`'s).
"""

__version__ = "0.1.0"


def _disable_thp() -> None:
    """Opt this process out of transparent huge pages.

    On the target VMs a 2 MB huge-page first-touch fault costs ~5 ms
    (host lazily backs guest memory at ~360 MB/s through them) while 4 KB
    faults run at ~2 GB/s — measured 12x faster first-touch for the big
    ingest buffers (decoded BAM, payload buffers, site arrays). Host
    tensors here are transfer staging, not compute, so THP's TLB upside
    is irrelevant. prctl(PR_SET_THP_DISABLE=41, 1) scopes the opt-out to
    this process only; failure is harmless.
    """
    try:
        import ctypes

        ctypes.CDLL("libc.so.6", use_errno=True).prctl(41, 1, 0, 0, 0)
    except Exception:  # pragma: no cover - best-effort
        pass


def _keep_large_allocations() -> None:
    """Serve large mallocs from the reusable heap instead of mmap.

    glibc mmaps allocations above M_MMAP_THRESHOLD and munmaps them on
    free, returning the pages to the kernel. On the target VMs guest
    pages released to the kernel lose their host backing (free-page
    reporting), so every fresh large buffer — the decoded BAM, payload
    buffers, site arrays, NW job tensors — re-pays first-touch faults
    that run as slow as ~30 MB/s, dominating whole host stages on
    repeat runs. Raising M_MMAP_THRESHOLD/M_TRIM_THRESHOLD keeps those
    buffers inside the process heap where freed pages stay backed:
    measured 2-8 GB/s refills vs 30-60 MB/s without (alloc+fill 128 MB
    loop). Costs peak-RSS retention only; the VMs have >100 GB RAM.
    """
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)  # M_TRIM_THRESHOLD
    except Exception:  # pragma: no cover - best-effort
        pass


_disable_thp()
_keep_large_allocations()

from .device import require_no_tf32, resolve_device  # noqa: F401,E402

require_no_tf32()
