"""ctypes bridge to the repository's native (C++) runtime, `native/`.

The port builds its own copy of the library from `native/*.cpp`, with
the flags of `native/Makefile`, into
`build/floria_tpu_torch/libfloria_native.so` under the repository root,
at first use (never at import) and again whenever a source is newer.

Concurrent processes (pytest workers, ranks) may all find the library
missing at once. The staleness check, the build and the load run under
an exclusive `fcntl.flock` on a lock file in the build directory, and
the compiler writes a per-process temporary name that `os.replace`
moves into place, so the library is built once and no process ever
loads a half-written file. A failed build or load raises: no consumer
of the port is ever handed `None`.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from . import threads

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(_REPO, "native")
BUILD_DIR = os.path.join(_REPO, "build", "floria_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libfloria_native.so")
# native/Makefile's CXXFLAGS and LDFLAGS.
CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread"]
LDFLAGS = ["-shared", "-lz", "-pthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(glob.glob(os.path.join(NATIVE_DIR, "*.cpp")))


def _stale(lib_path: str) -> bool:
    """True when the library is missing or a native source, header or
    the Makefile is newer than it."""
    if not os.path.exists(lib_path):
        return True
    lib_t = os.path.getmtime(lib_path)
    deps = (_sources() + glob.glob(os.path.join(NATIVE_DIR, "*.h"))
            + [os.path.join(NATIVE_DIR, "Makefile")])
    return any(os.path.getmtime(p) > lib_t for p in deps)


def build_and_load(build_dir: str = BUILD_DIR) -> ctypes.CDLL:
    """Build `build_dir`/libfloria_native.so if it is stale, then load
    it, all under the build directory's lock. Raises on a failed build
    or load."""
    os.makedirs(build_dir, exist_ok=True)
    lib_path = os.path.join(build_dir, os.path.basename(LIB_PATH))
    with open(os.path.join(build_dir, "libfloria_native.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if _stale(lib_path):
            tmp = f"{lib_path}.tmp{os.getpid()}"
            cmd = ["g++", *CXXFLAGS, *_sources(), *LDFLAGS, "-o", tmp]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=600)
            if proc.returncode != 0:
                raise RuntimeError("native build failed (%d):\n%s\n%s" % (
                    proc.returncode, " ".join(cmd), proc.stderr[-8000:]))
            os.replace(tmp, lib_path)
        return ctypes.CDLL(lib_path)


def get_lib() -> ctypes.CDLL:
    """The bound native library, building it first when needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = build_and_load()
            _bind(lib)
            _lib = lib
    return _lib


def _bind(lib) -> None:
    lib.floria_bgzf_inflate.restype = ctypes.c_int64
    lib.floria_bgzf_inflate.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
    lib.floria_bgzf_index.restype = ctypes.c_int64
    lib.floria_bgzf_index.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int64]
    lib.floria_bgzf_inflate_blocks.restype = ctypes.c_int32
    lib.floria_bgzf_inflate_blocks.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32]
    lib.floria_pack_windows.restype = None
    lib.floria_pack_windows.argtypes = [
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_int32]
    lib.floria_realign_jobs.restype = ctypes.c_int64
    lib.floria_realign_jobs.argtypes = [
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int32, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int32]
    lib.floria_csr_gather_range.restype = ctypes.c_int64
    lib.floria_csr_gather_range.argtypes = [
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.floria_csr_counts.restype = ctypes.c_int64
    lib.floria_csr_counts.argtypes = [
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
    lib.floria_dedup_jobs.restype = ctypes.c_int64
    lib.floria_dedup_jobs.argtypes = [
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")]
    lib.floria_format_vartig_info.restype = ctypes.c_int64
    lib.floria_format_vartig_info.argtypes = [
        ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_int32, ctypes.c_char_p, ctypes.c_int64]
    lib.floria_nw_batch.restype = ctypes.c_int64
    lib.floria_nw_batch.argtypes = [
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS"),
        ctypes.c_int32]
    lib.floria_realign_exact.restype = ctypes.c_int64
    lib.floria_realign_exact.argtypes = [
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS"),
        ctypes.c_int32]
    lib.floria_solve_flow.restype = ctypes.c_int32
    lib.floria_solve_flow.argtypes = [
        ctypes.c_int32,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_int32, ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")]
    lib.floria_counts_fold.restype = None
    lib.floria_counts_fold.argtypes = [
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_int32]
    lib.floria_link_diffs.restype = None
    lib.floria_link_diffs.argtypes = [
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")]
    lib.floria_baseline_sweep.restype = ctypes.c_int64
    lib.floria_baseline_sweep.argtypes = [
        np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        # epsilon crosses as a double: an f64 epsilon narrowed to f32
        # shifts every diff and p-value enough to flip the beam's pruning
        # at deep coverage.
        ctypes.c_int32, ctypes.c_int32, ctypes.c_double,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p]


def bgzf_member_index(data):
    """(in_off, out_off, out_size) for every BGZF member of `data`
    (header scan only, no inflation; out_off is the decoded prefix sum
    with a trailing total), or None on failure/non-BGZF."""
    lib = get_lib()
    buf = (data.ctypes.data_as(ctypes.c_char_p)
           if isinstance(data, np.ndarray) else data)
    cap = max(64, len(data) // 1024)
    while True:
        in_off = np.empty(cap, np.int64)
        out_size = np.empty(cap, np.int64)
        n = lib.floria_bgzf_index(buf, len(data), in_off, out_size, cap)
        if n >= 0 or n == -1:
            break
        cap = max(cap * 2, -n)
    if n <= 0:
        return None
    out_off = np.zeros(n + 1, np.int64)
    np.cumsum(out_size[:n], out=out_off[1:])
    return in_off[:n].copy(), out_off, out_size[:n].copy()


def bgzf_inflate_ranges(data, ranges, total_hint=None):
    """Inflate ONLY the BGZF members intersecting the given decoded
    [lo, hi) ranges, into a full-decoded-size uint8 array whose
    untouched regions stay unbacked virtual pages (np.empty). The
    contig->decoded-range sidecar (ingest/fastingest.py) turns this
    into the htslib-.bai analog: a rank phasing its contig shard
    inflates ~1/N of the BAM instead of all of it (a full inflate of
    the 500-contig scaling workload cost a FIXED ~17 s per rank per
    run, capping multi-process efficiency)."""
    lib = get_lib()
    idx = bgzf_member_index(data)
    if idx is None:
        return None
    in_off, out_off, out_size = idx
    n = len(in_off)
    want = np.zeros(n, dtype=bool)
    starts = out_off[:-1]
    ends = out_off[1:]
    for lo, hi in ranges:
        if hi > lo:
            want |= (starts < hi) & (ends > lo)
    sel = np.flatnonzero(want)
    out = np.empty(int(out_off[-1]), np.uint8)
    if len(sel):
        buf = (data.ctypes.data_as(ctypes.c_char_p)
               if isinstance(data, np.ndarray) else data)
        rc = lib.floria_bgzf_inflate_blocks(
            buf, len(data), np.ascontiguousarray(in_off[sel]),
            np.ascontiguousarray(starts[sel]),
            np.ascontiguousarray(out_size[sel]), len(sel),
            out.ctypes.data_as(ctypes.c_void_p), threads.num_threads())
        if rc != 0:
            return None
    return out


def bgzf_inflate(data: bytes, as_array: bool = False):
    lib = get_lib()
    # Fast path: index the BGZF members (no inflation), then inflate
    # them in parallel — one pass total instead of the two serial
    # passes (size + fill) the generic inflater needs.
    cap = max(64, len(data) // 1024)
    while True:
        in_off = np.empty(cap, np.int64)
        out_size = np.empty(cap, np.int64)
        n = lib.floria_bgzf_index(data, len(data), in_off, out_size, cap)
        if n >= 0 or n == -1:
            break
        cap = max(cap * 2, -n)
    if n > 0:
        out_off = np.zeros(n + 1, np.int64)
        np.cumsum(out_size[:n], out=out_off[1:])
        total = int(out_off[-1])
        out = np.empty(total, np.uint8)
        rc = lib.floria_bgzf_inflate_blocks(
            data, len(data), in_off[:n].copy(), out_off[:-1].copy(),
            out_size[:n].copy(), n,
            out.ctypes.data_as(ctypes.c_void_p), threads.num_threads())
        if rc == 0:
            # The numpy buffer is the decode target itself: no
            # whole-file bytes copy on return (as_array) and the
            # allocation reuses the process heap.
            return out if as_array else out.tobytes()
    size = lib.floria_bgzf_inflate(data, len(data), None, 0)
    if size < 0:
        return None
    out = np.empty(size, np.uint8)
    got = lib.floria_bgzf_inflate(data, len(data),
                                  out.ctypes.data_as(ctypes.c_void_p),
                                  size)
    if got != size:
        return None
    return out if as_array else out.tobytes()


def csr_gather_range(snps: np.ndarray, alleles: np.ndarray,
                     weights: np.ndarray, off: np.ndarray,
                     fids: np.ndarray, lo: int, hi: int
                     ) -> tuple:
    """(snps, alleles, weights, ridx) of the in-range [lo, hi] sites of
    the given frags, concatenated in frag order. A counting pass sizes the outputs exactly — a worst-case
    total-sites buffer is gigabytes for contig-spanning parts, and
    fresh-page faults dwarf the gather itself."""
    lib = get_lib()
    fids = np.ascontiguousarray(fids, np.int64)
    cap = int(lib.floria_csr_gather_range(
        snps, alleles, weights, off, fids, len(fids), lo, hi,
        None, None, None, None))
    out_s = np.empty(cap, np.int64)
    out_a = np.empty(cap, np.int8)
    out_w = np.empty(cap, np.float32)
    out_r = np.empty(cap, np.int32)
    n = lib.floria_csr_gather_range(
        snps, alleles, weights, off, fids, len(fids), lo, hi,
        out_s.ctypes.data_as(ctypes.c_void_p),
        out_a.ctypes.data_as(ctypes.c_void_p),
        out_w.ctypes.data_as(ctypes.c_void_p),
        out_r.ctypes.data_as(ctypes.c_void_p))
    return out_s[:n], out_a[:n], out_w[:n], out_r[:n]


def csr_counts(snps: np.ndarray, alleles: np.ndarray,
               weights: np.ndarray, off: np.ndarray, fids: np.ndarray,
               lo: int, hi: int, A: int, weighted: bool
               ) -> tuple:
    """Windowed consensus accumulation without materializing gathered
    rows: (counts f64 [S, A], exist i32 [S, A]) over [lo, hi], addition
    order identical to bincount over the gathered rows."""
    lib = get_lib()
    fids = np.ascontiguousarray(fids, np.int64)
    S = hi - lo + 1
    counts = np.zeros((S, A), np.float64)
    exist = np.zeros((S, A), np.int32)
    lib.floria_csr_counts(snps, alleles, weights, off, fids, len(fids),
                          lo, hi, A, 1 if weighted else 0,
                          counts.reshape(-1), exist.reshape(-1))
    return counts, exist


def dedup_jobs(q: np.ndarray, si: np.ndarray
               ) -> tuple:
    """(uniq_idx, inverse) for realignment jobs keyed by (window, SNP
    row)."""
    lib = get_lib()
    n, w2 = q.shape
    uniq_idx = np.empty(n, np.int64)
    inverse = np.empty(n, np.int64)
    n_uniq = lib.floria_dedup_jobs(
        np.ascontiguousarray(q), np.ascontiguousarray(si, np.int32),
        n, w2, uniq_idx, inverse)
    return uniq_idx[:n_uniq], inverse


def format_vartig_info(left: int, gpos: np.ndarray, has: np.ndarray,
                       bests: np.ndarray, cnt: np.ndarray,
                       present: np.ndarray) -> Optional[bytes]:
    """Render the vartig_info per-site lines; None when the buffer
    overflows (out/writers.py keeps the Python loop as the
    fallback/spec).
    gpos entries < 0 render as NA."""
    lib = get_lib()
    S, A = cnt.shape
    cap = 64 * S + 28 * S * A + 1024
    buf = ctypes.create_string_buffer(cap)
    n = lib.floria_format_vartig_info(
        left, S, np.ascontiguousarray(gpos, np.int64),
        np.ascontiguousarray(has, np.uint8),
        np.ascontiguousarray(bests, np.int64),
        np.ascontiguousarray(cnt, np.int64),
        np.ascontiguousarray(present, np.uint8), A, buf, cap)
    if n < 0:
        return None
    return buf.raw[:n]


def nw_batch(q: np.ndarray, si: np.ndarray, nal: np.ndarray,
             ref_tab: np.ndarray, al_tab: np.ndarray) -> np.ndarray:
    """Exact CPU Gotoh over packed query windows — cell-for-cell the
    device recurrence, so best-allele outputs are identical. For job
    partitions too small to amortize a device dispatch."""
    lib = get_lib()
    n, w2 = q.shape
    out = np.empty(n, np.int8)
    lib.floria_nw_batch(
        np.ascontiguousarray(q), np.ascontiguousarray(si, np.int32),
        np.ascontiguousarray(nal, np.int32),
        np.ascontiguousarray(ref_tab), np.ascontiguousarray(al_tab),
        n, al_tab.shape[1], w2, out, threads.num_threads())
    return out


def realign_exact(q: np.ndarray, si: np.ndarray, nal: np.ndarray,
                  var_tab: np.ndarray) -> np.ndarray:
    """Exact-window-match precheck for realignment jobs: [n] int8 best
    allele (-1 = unresolved, needs the device NW). q: [n, W//2] packed
    queries; si: [n] SNP rows; nal: [n] allele counts; var_tab:
    [T, A, W//2] packed candidate variants."""
    lib = get_lib()
    n = len(q)
    T, A, w2 = var_tab.shape
    out = np.empty(n, np.int8)
    lib.floria_realign_exact(
        np.ascontiguousarray(q), np.ascontiguousarray(si, np.int32),
        np.ascontiguousarray(nal, np.int32),
        np.ascontiguousarray(var_tab), n, A, w2, out,
        threads.num_threads())
    return out


def pack_windows(seq_buf: np.ndarray, qpos: np.ndarray,
                 flank: int) -> np.ndarray:
    """4-bit encode and pack [n, 2*flank] query windows gathered at
    qpos[i]-flank from the payload buffer, two codes per byte: [n, flank]
    uint8."""
    lib = get_lib()
    qpos = np.ascontiguousarray(qpos, dtype=np.int64)
    n = len(qpos)
    out = np.empty((n, flank), np.uint8)
    lib.floria_pack_windows(np.ascontiguousarray(seq_buf, dtype=np.uint8),
                            qpos, n, flank, out.reshape(-1),
                            threads.num_threads())
    return out


def baseline_sweep(alleles: np.ndarray, weights: np.ndarray,
                   ploidies, beam_width: int, epsilon: float,
                   max_alleles: int = 2, do_upem: bool = False,
                   faithful: bool = False, want_assign: bool = False):
    """The single-core C++ reference-semantics baseline
    (native/baseline.cpp) over [G, R, S] blocks, each block swept over
    `ploidies` in turn. faithful=True runs the hashmap variant that
    mirrors the reference's data structures, else the dense rewrite.
    Returns the last ploidy's assignments [G, R] int32 when want_assign,
    else the number of reads processed (G * R)."""
    lib = get_lib()
    alleles = np.ascontiguousarray(alleles, dtype=np.int8)
    weights = np.ascontiguousarray(weights, dtype=np.float32)
    G, R, S = alleles.shape
    pl = np.ascontiguousarray(ploidies, dtype=np.int32)
    out = np.zeros((G, R), dtype=np.int32) if want_assign else None
    out_ptr = out.ctypes.data_as(ctypes.c_void_p) if want_assign else None
    n = lib.floria_baseline_sweep(
        alleles.reshape(-1), weights.reshape(-1), G, R, S, pl, len(pl),
        beam_width, epsilon, max_alleles, int(do_upem), int(faithful),
        out_ptr)
    if want_assign:
        return out
    return int(n)


def realign_jobs(seq_buf: np.ndarray, rec: np.ndarray, qpos: np.ndarray,
                 snp: np.ndarray, pay_offs: np.ndarray,
                 genome_pos: np.ndarray, ref_len: int,
                 n_alleles: np.ndarray, flank: int, tab_base: int):
    """Single-pass realignment job packing (mask + window pack + SNP
    row/allele-count lookups + kept-site compaction). Returns
    (kept mask[n] bool, packed[nk, flank] uint8, si[nk] int32,
    nal[nk] int32, snp_counters[nk] int32 1-based, per-record counts)."""
    lib = get_lib()
    n = len(snp)
    kept = np.empty(n, np.uint8)
    packed = np.empty((n, flank), np.uint8)
    si = np.empty(n, np.int32)
    nal = np.empty(n, np.int32)
    snp_kept = np.empty(n, np.int32)
    rec_counts = np.zeros(len(pay_offs) - 1, np.int32)
    nk = lib.floria_realign_jobs(
        np.ascontiguousarray(seq_buf, np.uint8),
        np.ascontiguousarray(rec, np.int32),
        np.ascontiguousarray(qpos, np.int32),
        np.ascontiguousarray(snp, np.int32), n,
        np.ascontiguousarray(pay_offs, np.int64),
        np.ascontiguousarray(genome_pos, np.int64), ref_len,
        np.ascontiguousarray(n_alleles, np.int32), flank, tab_base,
        kept, packed.reshape(-1), si, nal, snp_kept, rec_counts,
        threads.num_threads())
    return (kept.view(bool), packed[:nk], si[:nk], nal[:nk],
            snp_kept[:nk], rec_counts)


def counts_fold(snps: np.ndarray, alleles: np.ndarray,
                weights: np.ndarray, off: np.ndarray, fids: np.ndarray,
                lo: int, counts: np.ndarray, add: bool) -> bool:
    """Sequentially fold the given frags' sites into `counts`
    ([span, A] f64 window starting at SNP `lo`), in frag-list order —
    add=True accumulates, add=False subtracts with the reference's
    nonzero-guard + zero clamp (utils_frags.rs:465-490). In-place; the
    per-read Python walk in post/finalize.py stays the fallback/spec.
    Returns True (the native fold ran)."""
    lib = get_lib()
    fids = np.ascontiguousarray(fids, np.int64)
    lib.floria_counts_fold(snps, alleles, weights, off, fids,
                           len(fids), lo, counts.shape[1],
                           counts.reshape(-1), 1 if add else 0)
    return True


def link_diffs(counts2: np.ndarray, exist2: np.ndarray,
               cols: np.ndarray, al: np.ndarray, w: np.ndarray,
               ridx: np.ndarray, F: int) -> np.ndarray:
    """[n2, F] f64 per-(next-block node, read) diff-weight sums for the
    hap-graph join — fused equivalent of the numpy mask+bincount pass
    in graph/edges.py (the bit-identical fallback/spec)."""
    lib = get_lib()
    n2, S2, A = counts2.shape
    n = len(cols)
    sums = np.zeros((n2, F), np.float64)
    lib.floria_link_diffs(
        np.ascontiguousarray(counts2), np.ascontiguousarray(exist2),
        n2, S2, A, np.ascontiguousarray(cols, np.int64),
        np.ascontiguousarray(al, np.int8),
        np.ascontiguousarray(w, np.float32),
        np.ascontiguousarray(ridx, np.int32), n, F,
        sums.reshape(-1))
    return sums


def solve_flow(ae: np.ndarray,
               conservation_rows) -> Optional[np.ndarray]:
    lib = get_lib()
    E = len(ae)
    ae = np.ascontiguousarray(ae, dtype=np.float64)
    if conservation_rows:
        cons = np.ascontiguousarray(np.stack(conservation_rows),
                                    dtype=np.float64)
        ncons = cons.shape[0]
        cons_ptr = cons.ctypes.data_as(ctypes.c_void_p)
    else:
        ncons = 0
        cons_ptr = None
    x = np.zeros(E, dtype=np.float64)
    rc = lib.floria_solve_flow(E, ae, ncons, cons_ptr, x)
    if rc != 0:
        return None
    return x
