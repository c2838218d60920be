"""SNP-local realignment (port of floria_tpu/kernels/realign.py).

Each (read, SNP) job globally aligns a 32 bp read window against the
reference window with every candidate allele substituted at the centre
(alignment.rs:7-64) and keeps the best-scoring allele. The job pool,
the window packing, the native Hamming precheck and the dedup of
identical problems are the reference's host code. What is left is
routed as the reference routes it (floria_tpu/kernels/realign.py:457-483):
biallelic jobs and the rest form two partitions; a partition of at most
CPP_MAX_JOBS jobs runs the exact native C++ Gotoh (`native.nw_batch`),
a larger one the device NW, `nw_best`: kernel K5 (csrc/nw_best.cu) on
CUDA tensors, its plain PyTorch version on CPU tensors.

The NW semantics are the reference's `_nw_scores` (realign.py:127-179),
not textbook Gotoh: match +1, mismatch -1, gap open -2 (including the
first gap base), extend -1; Ix opens from M only, Iy from M and Ix; the
sentinel is NEG = -16384. The reference runs the DP in int16; the port
runs it in int32, which gives the same integers because no value leaves
int16's range. Real cells of a 32x32 problem lie in [-68, 32] (every
path has at most 64 gap or mismatch steps, each costing at most 2 over
the open). Sentinel-derived cells are bounded too: M[0] is NEG in every
row, Ix is NEG - 1 in the first row only (from M = NEG - 2 and
Ix = NEG - 1) and is real from the second row on, and Iy[j >= 1] is
always real because Ix[0] = -2 - i is real in every row after the
boundary. The lowest value ever formed is NEG - 2 and the highest
(the reference's cummax offsets) is below 100, both well inside int16.
"""

from __future__ import annotations

import ctypes
import time
from typing import List, Optional

import numpy as np
import torch

from .. import native, timing
from ..device import resolve_device
from ..frag import Frag
from ..ingest.vcf import ContigVcf
from . import _build

FLANK = 16
WINDOW = 2 * FLANK
MATCH = 1
MISMATCH = -1
GAP_OPEN = -2
GAP_EXTEND = -1
NEG = -16384

# Jobs per step of the plain version: the reference's CPU chunk
# (floria_tpu/kernels/realign.py:74), which bounds host memory.
PLAIN_CHUNK_JOBS = 32768
# Partitions of at most this many jobs run the native C++ Gotoh, larger
# ones the device NW: the reference's threshold
# (floria_tpu/kernels/realign.py:470).
CPP_MAX_JOBS = 131072

# 4-bit sequence codes (the BAM nibble alphabet); unknown bytes -> 'N'.
_ALPHABET = b"=ACMGRSVTWYHKDBN"
_ENC = np.full(256, 15, dtype=np.uint8)
for _i, _b in enumerate(_ALPHABET):
    _ENC[_b] = _i

_OFFSETS = np.arange(-FLANK, FLANK)


def _pack4(codes: np.ndarray) -> np.ndarray:
    """[n, W] 4-bit codes -> [n, W//2] packed bytes (even idx = low
    nibble)."""
    return (codes[:, 0::2] | (codes[:, 1::2] << 4)).astype(np.uint8)


def nw_scores_plain(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Global affine-gap scores of equal-length code pairs q, r [N, W]
    (uint8): [N] int32, the reference's `_nw_scores` row scan with its
    cummax form of Iy, in int32 (module note)."""
    dtype = torch.int32
    N, W = q.shape
    dev = q.device
    j = torch.arange(W + 1, device=dev)                          # [W+1]
    m = torch.where(j == 0, 0, NEG).to(dtype).expand(N, W + 1)
    iy = torch.where(j == 0, NEG, GAP_OPEN + GAP_EXTEND * (j - 1)).to(
        dtype).expand(N, W + 1)
    ix = torch.full((N, W + 1), NEG, dtype=dtype, device=dev)
    neg_col = torch.full((N, 1), NEG, dtype=dtype, device=dev)
    # Iy[j] = e*j + cummax_{k<j}(max(M[k], Ix[k]) + o - e*(k+1))
    open_off = (GAP_OPEN - GAP_EXTEND * (j + 1)).to(dtype)
    ext = (GAP_EXTEND * j[1:]).to(dtype)
    for i in range(W):
        h = torch.maximum(torch.maximum(m, ix), iy)
        # match +1 / mismatch -1
        sub = (q[:, i:i + 1] == r).to(dtype) * (MATCH - MISMATCH) + MISMATCH
        m_new = torch.cat([neg_col, h[:, :-1] + sub], dim=1)
        ix = torch.maximum(m + GAP_OPEN, ix + GAP_EXTEND)
        ix[:, 0] = GAP_OPEN + GAP_EXTEND * i
        cm = torch.cummax(torch.maximum(m_new, ix) + open_off, dim=1).values
        iy = torch.cat([neg_col, cm[:, :-1] + ext], dim=1)
        m = m_new
    return torch.maximum(torch.maximum(m[:, -1], ix[:, -1]), iy[:, -1])


def nw_allele_scores_plain(q_packed, si, nal, ref_tab, al_tab,
                           a_max: int) -> torch.Tensor:
    """[N, a_max] int32 NW score of each job's query window against its
    reference window with allele a at the centre; NEG for a >= nal. The
    reference's `_nw_best_chunked` (realign.py:93-124) before its argmax,
    in chunks of PLAIN_CHUNK_JOBS jobs."""
    N = q_packed.shape[0]
    out = torch.empty((N, a_max), dtype=torch.int32, device=q_packed.device)
    alleles = torch.arange(a_max, device=q_packed.device)
    for lo in range(0, N, PLAIN_CHUNK_JOBS):
        qp = q_packed[lo:lo + PLAIN_CHUNK_JOBS]
        rows = si[lo:lo + PLAIN_CHUNK_JOBS].long()
        C = qp.shape[0]
        q = torch.stack([qp & 0xF, qp >> 4], dim=-1).reshape(C, WINDOW)
        var = ref_tab[rows][:, None, :].repeat(1, a_max, 1)     # [C, A, W]
        var[:, :, FLANK] = al_tab[rows, :a_max]
        qq = q[:, None, :].expand(C, a_max, WINDOW)
        sc = nw_scores_plain(qq.reshape(C * a_max, WINDOW),
                             var.reshape(C * a_max, WINDOW)).reshape(
                                 C, a_max)
        keep = alleles[None, :] < nal[lo:lo + PLAIN_CHUNK_JOBS, None]
        out[lo:lo + C] = torch.where(keep, sc, NEG)
    return out


def nw_best_plain(q_packed, si, nal, ref_tab, al_tab,
                  a_max: int) -> torch.Tensor:
    """Plain version of K5: [N] int8 best allele per job, the first index
    of the maximum score (jnp.argmax's tie rule; nal 0 or 1 gives 0)."""
    return nw_allele_scores_plain(q_packed, si, nal, ref_tab, al_tab,
                                  a_max).argmax(dim=1).to(torch.int8)


def nw_best_cuda(q_packed, si, nal, ref_tab, al_tab, a_max: int,
                 scores: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5 launch (csrc/nw_best.cu): [N] int8 best alleles. CUDA tensors
    only. With `scores` (int32 [N, a_max] on the same card) the kernel
    also writes every allele's score there, NEG for a >= nal. Checks
    every input, the SNP rows in `si` against the tables' rows included
    (one device sync), before the launch."""
    dev = q_packed.device
    if dev.type != "cuda":
        raise ValueError("nw_best_cuda needs CUDA tensors")
    N = q_packed.shape[0]
    T, A = al_tab.shape
    expect = {"q_packed": (q_packed, torch.uint8, (N, WINDOW // 2)),
              "si": (si, torch.int32, (N,)),
              "nal": (nal, torch.int32, (N,)),
              "ref_tab": (ref_tab, torch.uint8, (T, WINDOW)),
              "al_tab": (al_tab, torch.uint8, (T, A))}
    if scores is not None:
        expect["scores"] = (scores, torch.int32, (N, a_max))
    for name, (x, dt, shape) in expect.items():
        if x.device != dev or x.dtype != dt or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(
                f"nw_best_cuda: {name} must be a contiguous {dt} "
                f"{shape} tensor on {dev}, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")
    if not 1 <= a_max <= A:
        raise ValueError(f"nw_best_cuda: a_max={a_max} outside 1..{A}")
    for name, x in (("q_packed", q_packed), ("ref_tab", ref_tab)):
        if x.data_ptr() % 16:
            raise ValueError(f"nw_best_cuda: {name} must be 16-byte "
                             "aligned (the kernel loads 16-byte vectors)")
    if N:
        lo, hi = torch.stack(torch.aminmax(si)).tolist()
        if lo < 0 or hi >= T:
            raise ValueError(f"nw_best_cuda: si holds rows {lo}..{hi}, "
                             f"outside the tables' 0..{T - 1}")
    best = torch.empty(N, dtype=torch.int8, device=dev)
    lib = _build.get_lib()
    ptr = ctypes.c_void_p
    with torch.cuda.device(dev):
        rc = lib.floria_nw_best(
            *(ptr(x.data_ptr()) for x in (q_packed, si, nal, ref_tab,
                                          al_tab, best)),
            ptr(None if scores is None else scores.data_ptr()),
            N, A, a_max, ptr(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(rc, "nw_best")
    _build.count_launch("nw_best")
    return best


def nw_best(q_packed, si, nal, ref_tab, al_tab, a_max: int) -> torch.Tensor:
    """The device NW of one job partition, in the reference's layout:
    q_packed [N, 16] uint8 query windows (even index = low nibble), si
    [N] int32 rows into ref_tab [T, 32] uint8 codes and al_tab [T, A]
    uint8 allele codes, nal [N] int32 allele counts, and a_max <= A
    alleles tried. Returns [N] int8 best alleles. CUDA tensors go to
    K5, CPU tensors to the plain version."""
    if q_packed.device.type == "cuda":
        return nw_best_cuda(q_packed, si, nal, ref_tab, al_tab, a_max)
    return nw_best_plain(q_packed, si, nal, ref_tab, al_tab, a_max)


class RealignPool:
    """Contig-agnostic job pool: packed query windows + SNP row indices
    into concatenated per-contig SNP tables, so a whole contig group
    realigns in one flush."""

    def __init__(self):
        self._q: List[np.ndarray] = []
        self._si: List[np.ndarray] = []
        self._nal: List[np.ndarray] = []
        self._targets: List = []
        self._tab_r: List[np.ndarray] = []
        self._tab_al: List[np.ndarray] = []
        self._tab_rows: int = 0
        self._gen: int = 0


class SnpRealigner:
    """Collects (read, SNP) realignment jobs for one contig into a
    (possibly shared) RealignPool."""

    def __init__(self, ref_seq: bytes, contig_vcf: ContigVcf,
                 pool: "RealignPool" = None):
        self.ref = np.frombuffer(ref_seq.upper(), dtype=np.uint8)
        self.cv = contig_vcf
        self.allele_mat = contig_vcf.allele_matrix()
        self.n_alleles = (self.allele_mat > 0).sum(axis=1)
        self.pool = pool if pool is not None else RealignPool()
        self._tab_base = None
        self._tab_gen = -1

    def _ensure_tables(self) -> int:
        """Register this contig's per-SNP tables in the pool (once per
        pool generation)."""
        if self._tab_base is None or self._tab_gen != self.pool._gen:
            self._tab_gen = self.pool._gen
            pool = self.pool
            self._tab_base = pool._tab_rows
            gn = self.cv.genome_pos.astype(np.int64)
            idx = np.clip(gn[:, None] + _OFFSETS, 0,
                          max(0, len(self.ref) - 1))
            pool._tab_r.append(_ENC[self.ref[idx]])
            pool._tab_al.append(_ENC[self.allele_mat])
            pool._tab_rows += len(gn)
        return self._tab_base

    def realign(self, frag: Frag) -> None:
        """Queue one fragment (pure-Python ingest path)."""
        if not frag.seq_dict:
            return
        snps = np.fromiter(frag.seq_dict.keys(), dtype=np.int64,
                           count=len(frag.seq_dict))
        qpos = np.fromiter(
            (frag.snp_pos_to_seq_pos[int(p)][1] for p in snps),
            dtype=np.int64, count=len(snps))
        self.add_jobs(frag, snps, qpos,
                      np.frombuffer(frag.seq_string[0].upper(),
                                    dtype=np.uint8))

    def add_jobs(self, frag: Frag, snp_counters: np.ndarray,
                 qpos: np.ndarray, seq: np.ndarray) -> None:
        """Queue sites given as arrays (1-based SNP counters)."""
        snp_idx = snp_counters.astype(np.int64) - 1
        gn = self.cv.genome_pos[snp_idx]
        ok = ((gn >= FLANK) & (gn + FLANK < len(self.ref))
              & (qpos >= FLANK) & (qpos + FLANK < len(seq)))
        if not ok.any():
            return
        base = self._ensure_tables()
        qp = qpos[ok]
        pool = self.pool
        pool._q.append(_pack4(_ENC[seq[qp[:, None] + _OFFSETS]]))
        pool._si.append((base + snp_idx[ok]).astype(np.int32))
        pool._nal.append(self.n_alleles[snp_idx[ok]])
        pool._targets.append((frag, snp_counters[ok]))

    def add_jobs_from_records(self, seq_buf: np.ndarray,
                              pay_offs: np.ndarray, out_rec: np.ndarray,
                              out_qpos: np.ndarray, out_snp: np.ndarray,
                              rec_targets) -> None:
        """Queue a whole contig's jobs from the native ingest's flat site
        arrays in one native pass (`native.realign_jobs`; the native
        ingest that calls this has the native library loaded)."""
        if not len(out_snp):
            return
        base = self._ensure_tables()
        _kept, packed, si, nal, snp_kept, rec_counts = native.realign_jobs(
            seq_buf, out_rec, out_qpos, out_snp, pay_offs,
            self.cv.genome_pos, len(self.ref), self.n_alleles, FLANK, base)
        if not len(si):
            return
        pool = self.pool
        pool._q.append(packed)
        pool._si.append(si)
        pool._nal.append(nal)
        offs = np.zeros(len(rec_counts) + 1, np.int64)
        np.cumsum(rec_counts, out=offs[1:])
        for frag, sl in rec_targets:
            rid = int(out_rec[sl.start])
            o, e = int(offs[rid]), int(offs[rid + 1])
            if e > o:
                pool._targets.append((frag, snp_kept[o:e]))

    def flush(self, device) -> None:
        flush_pool(self.pool, device=device)


def flush_pool(pool: RealignPool, *, device) -> None:
    """Resolve every queued job and write the calls into the frags:
    native Hamming precheck, dedup of identical problems, then the NW of
    each partition on the C++ Gotoh or `nw_best` on `device` (module
    note). Raises when the native library is unavailable (there is no
    other path)."""
    if not pool._targets:
        return
    dev = resolve_device(device)
    _t = time.time()
    q = np.concatenate(pool._q)
    si = np.concatenate(pool._si)
    nal = np.concatenate(pool._nal).astype(np.int32)
    ref_tab = np.concatenate(pool._tab_r)
    al_tab = np.concatenate(pool._tab_al)
    A = al_tab.shape[1]

    var = np.repeat(ref_tab[:, None, :], A, axis=1)
    var[:, :, FLANK] = al_tab
    var_packed = np.ascontiguousarray(
        (var[:, :, 0::2] | (var[:, :, 1::2] << 4)).astype(np.uint8))
    best = native.realign_exact(q, si, nal, var_packed)
    # Jobs the Hamming precheck could not prove go to the NW; reads
    # with identical windows at one SNP are one problem, solved once.
    rest = np.nonzero(best < 0)[0]
    if len(rest):
        uniq_local, inv = native.dedup_jobs(q[rest], si[rest])
        uniq = rest[uniq_local]
    timing.add("realign.host_prep", time.time() - _t)
    _t = time.time()
    if len(rest):
        bi = nal[uniq] <= 2
        tables = None
        for sel, a_max in ((bi, min(2, A)), (~bi, A)):
            idx = uniq[sel]
            if not len(idx):
                continue
            _tp = time.time()
            if len(idx) <= CPP_MAX_JOBS:
                best[idx] = native.nw_batch(q[idx], si[idx], nal[idx],
                                            ref_tab, al_tab)
                timing.add("realign.device.cpp", time.time() - _tp)
                continue
            if tables is None:  # uploaded once per flush
                tables = [torch.from_numpy(x).to(dev)
                          for x in (ref_tab, al_tab)]
            jobs = [torch.from_numpy(x).to(dev)
                    for x in (q[idx], si[idx], nal[idx])]
            best[idx] = nw_best(*jobs, *tables, a_max).cpu().numpy()
            timing.add("realign.device.nw_best", time.time() - _tp)
        best[rest] = best[uniq][inv]
    timing.add("realign.device", time.time() - _t)
    _t = time.time()

    off = 0
    for frag, snp_pos in pool._targets:
        calls = best[off:off + len(snp_pos)]
        off += len(snp_pos)
        frag.set_calls(snp_pos, calls)
    pool._q.clear()
    pool._si.clear()
    pool._nal.clear()
    pool._targets.clear()
    pool._tab_r.clear()
    pool._tab_al.clear()
    pool._tab_rows = 0
    pool._gen += 1
    timing.add("realign.scatter", time.time() - _t)
