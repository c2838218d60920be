"""Block-length / epsilon auto-estimation from BAM pileup sampling.

file_reader.rs:749-826: walk pileup columns, process every 1000th one;
per processed column, every covering non-deleted alignment contributes
its (non-hard-clipped) read length, and the column's error = non-majority
/ majority base fraction when depth >= 5; stop once 1000 error entries
are collected; epsilon = max(66th percentile column error, 0.01); block
length = max(66th percentile of the collected read lengths, 500).

One pass over reads: each read's aligned pairs against ALL sampled
columns are extracted once (aligned_snp_pairs), then per-column base
counts are scatter-adds — O(reads + pairs) instead of the round-1
O(columns x covering reads) re-walk. The reference's sampling counter
runs over the whole pileup stream, so the every-1000th stride here
carries across contigs instead of restarting.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .. import constants
from . import bam as bamlib


def _sampled_columns(records, offset: int) -> Tuple[np.ndarray, int]:
    """Every 1000th covered reference column (pileup stride), given the
    global covered-column count so far. Returns (positions, n_covered)."""
    events = []
    for r in records:
        events.append((r.pos, 1))
        events.append((r.reference_end(), -1))
    events.sort()
    intervals = []
    depth = 0
    prev = None
    for pos, d in events:
        if prev is not None and depth > 0 and pos > prev:
            intervals.append((prev, pos))
        depth += d
        prev = pos
    cols = []
    g = offset
    for a, b in intervals:
        n = b - a
        first = (-g) % 1000
        if first < n:
            cols.append(a + np.arange(first, n, 1000, dtype=np.int64))
        g += n
    if cols:
        return np.concatenate(cols), g - offset
    return np.empty(0, dtype=np.int64), g - offset


def l_epsilon_auto_detect(bam_path: str) -> Tuple[int, float]:
    bf = bamlib.BamFile(bam_path)
    stop = 1000
    err_parts = []       # per contig: (col_index_in_order, err) arrays
    len_parts = []       # per contig: (col_index_in_order, read_len)
    n_err = 0
    col_base = 0         # global ordering offset for column indices
    covered_offset = 0   # global covered-column count (sampling stride)
    by_contig = bf.records_by_contig()
    for tid in sorted(by_contig):
        if tid < 0:
            continue
        records = [r for r in by_contig[tid]
                   if not (r.flag & (bamlib.ERRORS_MASK
                                     | bamlib.FLAG_SECONDARY))
                   and len(r.seq)]
        if not records:
            continue
        sampled, n_cov = _sampled_columns(records, covered_offset)
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
        col_idx = np.concatenate(col_idx_list)
        bases = np.concatenate(base_list)
        rlens = np.concatenate(rlen_list)
        # Per-(column, base) counts -> per-column depth and majority.
        n_cols = len(sampled)
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
