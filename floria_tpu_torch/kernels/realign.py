"""SNP-local realignment, host half (port of floria_tpu/kernels/realign.py).

Each (read, SNP) job globally aligns a 32 bp read window against the
reference window with every candidate allele substituted at the centre
(alignment.rs:7-64) and keeps the best-scoring allele. The job pool,
the window packing and the native Hamming precheck are the reference's
host code; every remaining partition goes to the exact native C++ Gotoh
(`native.nw_batch`), which tests/test_native_nw.py pins bit-equal to
the reference's device NW kernel. The device NW kernel is later work.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

from floria_tpu import native
from floria_tpu.frag import Frag
from floria_tpu.ingest.vcf import ContigVcf

from .. import timing

FLANK = 16

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

    def flush(self) -> None:
        flush_pool(self.pool)


def flush_pool(pool: RealignPool) -> None:
    """Resolve every queued job and write the calls into the frags:
    native Hamming precheck, dedup of identical problems, then the exact
    native Gotoh for everything left. Raises when the native library is
    unavailable (there is no other path)."""
    if not pool._targets:
        return
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
    if best is None:
        raise RuntimeError("native realignment library unavailable "
                           "(floria_tpu.native.get_lib() failed)")
    # Jobs the Hamming precheck could not prove go to the Gotoh; reads
    # with identical windows at one SNP are one problem, solved once.
    rest = np.nonzero(best < 0)[0]
    if len(rest):
        uniq_local, inv = native.dedup_jobs(q[rest], si[rest])
        uniq = rest[uniq_local]
    timing.add("realign.host_prep", time.time() - _t)
    _t = time.time()
    if len(rest):
        best[uniq] = native.nw_batch(q[uniq], si[uniq], nal[uniq],
                                     ref_tab, al_tab)
        best[rest] = best[uniq][inv]
    timing.add("realign.cpp", time.time() - _t)
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
