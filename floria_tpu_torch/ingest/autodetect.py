"""Block-length / epsilon auto-estimation from BAM pileup sampling.

file_reader.rs:749-826: walk pileup columns, process every 1000th one;
per processed column, every covering non-deleted alignment contributes
its (non-hard-clipped) read length, and the column's error = non-majority
/ majority base fraction when depth >= 5; stop once 1000 error entries
are collected; epsilon = max(66th percentile column error, 0.01); block
length = max(66th percentile of the collected read lengths, 500).

One pass over reads: each read's aligned pairs against ALL sampled
columns are extracted once, then per-column base counts are scatter-adds
— O(reads + pairs) instead of the round-1 O(columns x covering reads)
re-walk. The reference's sampling counter runs over the whole pileup
stream, so the every-1000th stride here carries across contigs instead
of restarting.

The BAM is read through the native scanner the pipeline's ingest uses
(`fastingest.FastBam`): the records' fields come from its flat arrays,
the reads' reference ends and their bases at the sampled columns from
the C++ CIGAR walk (`floria_extract_sites`, given all 16 BAM base codes
as each column's alleles, so the allele index it returns is the base's
code). No read's sequence or quals are unpacked. Where the native path
is unavailable (the test `pipeline.open_bam` makes), the pure decoder
(`bam.BamFile`) gives the same estimate.
"""

from __future__ import annotations

import logging
from typing import Iterator, Tuple

import numpy as np

from .. import constants, native, timing
from . import bam as bamlib

log = logging.getLogger(__name__)

STRIDE = 1000
# Every BAM base code, as each sampled column's allele list.
_ALL_CODES = np.frombuffer(bamlib.SEQ_CODES.encode(), dtype=np.uint8)


def _strided_columns(pos: np.ndarray, end: np.ndarray, offset: int
                     ) -> Tuple[np.ndarray, int]:
    """Every 1000th covered reference column (pileup stride) of the union
    of the reads' [pos, end) intervals, counted from the global
    covered-column count `offset`. Returns (positions, n_covered)."""
    live = end > pos
    if not live.any():
        return np.empty(0, dtype=np.int64), 0
    order = np.argsort(pos[live], kind="stable")
    s = pos[live][order]
    e = end[live][order]
    reach = np.maximum.accumulate(e)
    first_of = np.flatnonzero(np.r_[True, s[1:] > reach[:-1]])
    starts = s[first_of]
    lens = reach[np.r_[first_of[1:] - 1, len(s) - 1]] - starts
    before = offset + np.cumsum(lens) - lens
    first = (-before) % STRIDE
    n_cols = np.where(first < lens, (lens - first + STRIDE - 1) // STRIDE,
                      0)
    iv = np.repeat(np.arange(len(starts)), n_cols)
    k = np.arange(int(n_cols.sum())) - np.repeat(np.cumsum(n_cols) - n_cols,
                                                 n_cols)
    return starts[iv] + first[iv] + STRIDE * k, int(lens.sum())


def _pure_contigs(bam_path: str) -> Iterator[tuple]:
    """(n_cols, col_idx, bases, read_lens) of each contig in tid order,
    from records decoded in Python."""
    by_contig = bamlib.BamFile(bam_path).records_by_contig()
    covered_offset = 0   # global covered-column count (sampling stride)
    for tid in sorted(by_contig):
        if tid < 0:
            continue
        records = [r for r in by_contig[tid]
                   if not (r.flag & (bamlib.ERRORS_MASK
                                     | bamlib.FLAG_SECONDARY))
                   and len(r.seq)]
        if not records:
            continue
        sampled, n_cov = _strided_columns(
            np.array([r.pos for r in records], dtype=np.int64),
            np.array([r.reference_end() for r in records], dtype=np.int64),
            covered_offset)
        covered_offset += n_cov
        if len(sampled) == 0:
            continue
        # One aligned-pair extraction per read against all sampled
        # columns at once.
        col_idx_list = []
        base_list = []
        rlen_list = []
        for r in records:
            qpos, rpos = bamlib.aligned_snp_pairs(r, sampled)
            if len(qpos) == 0:
                continue
            idx = np.searchsorted(sampled, rpos)
            col_idx_list.append(idx)
            seq = np.frombuffer(r.seq, dtype=np.uint8) \
                if isinstance(r.seq, (bytes, bytearray)) \
                else np.asarray(bytearray(r.seq), dtype=np.uint8)
            base_list.append(seq[qpos])
            rlen_list.append(np.full(len(qpos), len(r.seq),
                                     dtype=np.int64))
        if not col_idx_list:
            continue
        yield (len(sampled), np.concatenate(col_idx_list),
               np.concatenate(base_list), np.concatenate(rlen_list))


def _walk(lib, fb, rec_off: np.ndarray, cols: np.ndarray, cap: int):
    """One `floria_extract_sites` call over records `rec_off` with every
    base code allowed at each of `cols`: (record, column, base code) of
    each pair on an M/=/X op, and each record's reference end."""
    n = len(rec_off)
    alleles = np.ascontiguousarray(
        np.broadcast_to(_ALL_CODES, (len(cols), len(_ALL_CODES))))
    out_rec = np.empty(cap, np.int32)
    out_col = np.empty(cap, np.int32)
    out_base = np.empty(cap, np.uint8)
    out_qual = np.empty(cap, np.uint8)
    out_qpos = np.empty(cap, np.int32)
    rec_end = np.empty(n, np.int64)
    got = lib.floria_extract_sites(
        fb._ptr, rec_off, n, cols, len(cols), alleles, len(_ALL_CODES),
        cap, out_rec, out_col, out_base, out_qual, out_qpos, rec_end)
    if got < 0:
        raise RuntimeError("sampled-column pairs overran their bound")
    return out_rec[:got], out_col[:got], out_base[:got], rec_end


def _native_contigs(fb) -> Iterator[tuple]:
    """`_pure_contigs` through the native scanner: the same filter,
    columns and pairs, with no read's sequence unpacked."""
    lib = native.get_lib()
    keep = np.flatnonzero(
        ((fb.flag & (bamlib.ERRORS_MASK | bamlib.FLAG_SECONDARY)) == 0)
        & (fb.l_seq > 0) & (fb.tid >= 0))
    timing.count("estimate_records", len(keep))
    if len(keep) == 0:
        return
    # Stable by tid: each contig's records in file order.
    keep = keep[np.argsort(fb.tid[keep], kind="stable")]
    rec_off = np.ascontiguousarray(fb.rec_off[keep])
    pos = fb.pos[keep].astype(np.int64)
    read_len = fb.l_seq[keep].astype(np.int64)
    end = _walk(lib, fb, rec_off, np.empty(0, np.int64), 0)[3]
    tids = fb.tid[keep]
    bounds = np.flatnonzero(np.r_[True, tids[1:] != tids[:-1], True])
    covered_offset = 0
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        sampled, n_cov = _strided_columns(pos[lo:hi], end[lo:hi],
                                          covered_offset)
        covered_offset += n_cov
        if len(sampled) == 0:
            continue
        # A read's span holds at most one sampled column in every
        # STRIDE of its reference columns.
        cap = int(((end[lo:hi] - pos[lo:hi]) // STRIDE + 1).sum())
        rec, col, base, _ = _walk(lib, fb, rec_off[lo:hi], sampled, cap)
        if len(rec) == 0:
            continue
        yield len(sampled), col, base, read_len[lo:hi][rec]


def _open_native(bam_path: str):
    """The native scanner's decode of the BAM, or None where the native
    path is unavailable (as `pipeline.open_bam` decides)."""
    try:
        from .fastingest import FastBam
        return FastBam(bam_path)
    except Exception as e:
        log.debug("native BAM path unavailable (%s); using pure decoder",
                  e)
        return None


def l_epsilon_auto_detect(bam_path: str) -> Tuple[int, float]:
    fb = _open_native(bam_path)
    if fb is None:
        timing.count("estimate_records", 0)
        contigs = _pure_contigs(bam_path)
    else:
        contigs = _native_contigs(fb)
    stop = 1000
    err_parts = []       # per contig: (col_index_in_order, err) arrays
    len_parts = []       # per contig: (col_index_in_order, read_len)
    n_err = 0
    col_base = 0         # global ordering offset for column indices
    for n_cols, col_idx, bases, rlens in contigs:
        # Per-(column, base) counts -> per-column depth and majority.
        keyed = col_idx.astype(np.int64) * 256 + bases
        counts = np.bincount(keyed, minlength=n_cols * 256).reshape(
            n_cols, 256)
        total = counts.sum(axis=1).astype(np.float64)
        most = counts.max(axis=1).astype(np.float64)
        has_err = total >= 5.0
        err_cols = np.flatnonzero(has_err)
        errs = (total[err_cols] - most[err_cols]) / most[err_cols]
        err_parts.append((col_base + err_cols, errs))
        len_parts.append((col_base + col_idx, rlens))
        col_base += n_cols
        n_err += len(err_cols)
        if n_err >= stop:
            break
    if not len_parts:
        return constants.MINIMUM_BLOCK_SIZE, 0.01
    err_cols = np.concatenate([c for c, _e in err_parts]) \
        if err_parts else np.empty(0, dtype=np.int64)
    errs = np.concatenate([e for _c, e in err_parts]) \
        if err_parts else np.empty(0)
    order = np.argsort(err_cols, kind="stable")
    errs = errs[order]
    # Early stop replay: the reference breaks after the column that
    # brings err_vec to 1000 entries; read lengths from later columns
    # are never collected.
    if len(errs) >= stop:
        cut_col = err_cols[order][stop - 1]
        errs = errs[:stop]
    else:
        cut_col = np.iinfo(np.int64).max
    len_cols = np.concatenate([c for c, _l in len_parts])
    rlens = np.concatenate([l for _c, l in len_parts])
    rlens = rlens[len_cols <= cut_col]
    if len(rlens) == 0:
        return constants.MINIMUM_BLOCK_SIZE, 0.01
    rlens.sort()
    q_66 = int(rlens[len(rlens) * 66 // 100])
    errs.sort()
    med66 = float(errs[len(errs) * 66 // 100]) if len(errs) else 0.0
    final_eps = max(med66, 0.01)
    final_l = max(q_66, constants.MINIMUM_BLOCK_SIZE)
    return final_l, final_eps
