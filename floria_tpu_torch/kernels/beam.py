"""Batched beam-search phasing: the port of floria_tpu/kernels/beam.py.

One beam slot's state is its part-wise allele counts [P, A, S] plus its
cumulative MEC score; one step inserts one read into every live slot,
prunes with the binomial tail + log-sum-exp posterior, dedups duplicate
truncated blocks by fingerprints (per part a wrapping-u32 sum; for a
candidate the exact sum of its parts' and its read's wrapped u32
products, as the reference's x64 reduction leaves it), and keeps the best
`out_slots` candidates in (score asc, generation asc) order. The first
BEAM_WARMUP_READS reads keep ploidy * W slots, a transition step selects
W, the rest scan W slots (global_clustering.rs:10-208).

The reference carries three bitwise-equal TPU state layouts (planes /
hist / counts). Hopper has native int64 and f64, so the port keeps one
exact state: int64 weight quanta (every phred weight is an integer
multiple of 2^-26, options.py), an int8 per-slot assignment history for
the dedup fingerprints, f64 integer-quanta scores, and integer parents.

Two implementations, one semantics:
- `beam_scan_plain`: PyTorch tensor ops, batched over instances, one
  Python step per read. The CPU path and the reference the CUDA kernel
  is held against on the card.
- `beam_scan_cuda`: csrc/beam_scan.cu (K1), one CTA (or, for small
  batches, one thread-block cluster) per instance with the read loop
  inside the kernel and the traceback in its epilogue. It touches only
  each step's frontier columns (`frontier_bounds`) and computes the dedup
  fingerprints from its counts, so it needs no suffix-hash rows.
`beam_search_batch_mixed` / `beam_search_traceback` (and the fixed-ploidy
`beam_search_batch`) pick by the tensors' device: CUDA tensors go to the
kernel, CPU tensors to the plain version. `traceback` walks one
instance's records on the host.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import constants, state
from ..device import check_no_tf32, resolve_device, upload
from . import _build
from .scores import binom_tail, log_sum_exp

WEIGHT_SCALE = float(1 << 26)
INV_WEIGHT_SCALE = 1.0 / (1 << 26)
INF = float("inf")
# Finite stand-ins for INF during ranking, as float32 constants widened
# to f64 exactly as the reference's jnp.float32(1e30) / (1e29) promote.
BIG = float(np.float32(1e30))
BIG_CUT = float(np.float32(1e29))
CUTOFF = math.log(constants.PROB_CUTOFF)
MASK32 = 0xFFFFFFFF


class BeamResult(NamedTuple):
    """Per-phase traceback records + final beam state (the reference's
    layout: warm [G, T1, B1], main [G, R - T1, W], final [G, Bf])."""
    warm_parents: torch.Tensor
    warm_parts: torch.Tensor
    main_parents: torch.Tensor
    main_parts: torch.Tensor
    scores: torch.Tensor     # f64 integer quanta
    live: torch.Tensor       # bool


def quals_to_weights(quals: torch.Tensor, table: torch.Tensor
                     ) -> torch.Tensor:
    """Weights from uint8 phred quals by table lookup (`table` from
    state.phred_table, on the quals' device)."""
    return torch.take(table, quals.long())


def _read_starts(covered: torch.Tensor, S: int) -> torch.Tensor:
    """First covered column per read (S for all-padding rows). [G, R]."""
    col = torch.argmax(covered.to(torch.uint8), dim=-1)
    has = covered.any(dim=-1)
    return torch.where(has, col, torch.full_like(col, S)).to(torch.int32)


def _window_offsets(covered: torch.Tensor, S: int, window: int
                    ) -> torch.Tensor:
    """Per-read 128-aligned window starts, clipped into [0, S - window]
    and made monotone (cummax). [G, R] int32."""
    if window >= S:
        return torch.zeros(covered.shape[:-1], dtype=torch.int32,
                           device=covered.device)
    start = torch.clamp(_read_starts(covered, S).long(), max=S - 1)
    off = torch.clamp((start // 128) * 128, max=S - window)
    return torch.cummax(off, dim=-1).values.to(torch.int32)


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 tensors holding u32 values, without
    int64 overflow (split a into 16-bit halves)."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def _suffix_hash(alleles: torch.Tensor, weights: torch.Tensor,
                 h: torch.Tensor) -> torch.Tensor:
    """z[g, s, r] = sum_{s' >= s} (w * 2^26)[r, s'] * H[allele_{r,s'}, s']
    mod 2^32, with a zero row at s = S. [G, S+1, R] int64 (u32 values)."""
    G, R, S = alleles.shape
    A = h.shape[0]
    a = alleles.long()
    ok = (a >= 0) & (a < A)
    cols = torch.arange(S, device=a.device).expand(G, R, S)
    hsel = torch.where(ok, h[a.clamp(0, A - 1), cols],
                       torch.zeros((), dtype=torch.int64, device=a.device))
    wq = (weights * np.float32(WEIGHT_SCALE)).to(torch.int64)
    contrib = (wq * hsel) & MASK32
    z = torch.flip(torch.cumsum(torch.flip(contrib, [-1]), dim=-1),
                   [-1]) & MASK32
    z = torch.cat([z, torch.zeros((G, R, 1), dtype=torch.int64,
                                  device=a.device)], dim=-1)
    return z.transpose(1, 2)


def _zrows(alleles, weights, starts, hs) -> torch.Tensor:
    """Suffix-hash rows at every read's start column:
    zrows[g, f, t, r] = z_f[g, starts[g, t], r]. [G, F, R, R] int64."""
    G, R, _S = alleles.shape
    idx = starts.long()[:, :, None].expand(G, R, R)
    return torch.stack([_suffix_hash(alleles, weights, h).gather(1, idx)
                        for h in hs], dim=1).contiguous()


def _eps(epsilon):
    """(f64 epsilon, epsilon in integer weight quanta)."""
    eps64 = epsilon.to(torch.float64)
    return eps64, torch.round(eps64 * WEIGHT_SCALE).to(torch.int64)


def _prepare(alleles, weights, epsilon, A, P, window, dedup):
    """Per-read setup of the plain scan (the reference's `_read_starts`,
    `_window_offsets`, `_suffix_hash` in wrapping u32 emulated in
    int64)."""
    G, R, S = alleles.shape
    dev = alleles.device
    eps64, epsq = _eps(epsilon)
    covered = alleles >= 0
    offs = _window_offsets(covered, S, window)
    hs, gmix, _phred = state.from_reference(
        *state.dedup_hash_consts(A, S, P), state.phred_table(), dev)
    if dedup:
        zrows = _zrows(alleles, weights, _read_starts(covered, S), hs)
    else:
        zrows = torch.zeros((G, state.NUM_FINGERPRINTS, 1, 1),
                            dtype=torch.int64, device=dev)
    return eps64, epsq, offs, zrows, gmix.contiguous()


def _rec_dtype(B1: int) -> torch.dtype:
    return torch.int8 if B1 <= 127 else torch.int16


def beam_scan_plain(alleles, weights, num_reads, eps64, epsq, num_parts,
                    offs, zrows, gmix, *, P: int, W: int, A: int,
                    window: int, dedup: bool = True) -> BeamResult:
    """Plain PyTorch beam scan (any device). See the module docstring;
    arguments as `_prepare` makes them, window already resolved
    (window >= S means full width)."""
    G, R, S = alleles.shape
    dev = alleles.device
    B1 = P * W
    T1 = min(constants.BEAM_WARMUP_READS, R)
    rec_dt = _rec_dtype(B1)
    Wn = window if window < S else S
    i64, f64 = torch.int64, torch.float64

    counts = torch.zeros((G, B1, P, A, S), dtype=i64, device=dev)
    hist = torch.full((G, B1, R), -1, dtype=torch.int8, device=dev)
    slot0 = torch.arange(B1, device=dev) == 0
    score = torch.where(slot0, 0.0, INF).to(f64).expand(G, B1).clone()
    live = slot0.expand(G, B1).clone()
    parts_ar = torch.arange(P, device=dev)
    part_active = parts_ar[None, :] < num_parts.long()[:, None]   # [G, P]
    warm_width = num_parts.long() * W
    a_ar = torch.arange(A, device=dev)
    w_ar = torch.arange(Wn, device=dev)
    num_reads = num_reads.long()

    w_par, w_prt, m_par, m_prt = [], [], [], []
    for t in range(R):
        B = counts.shape[1]
        N = B * P
        outs = B1 if t < T1 else W
        width = warm_width if t < T1 else torch.full_like(warm_width, W)
        valid = t < num_reads                                    # [G]
        if window < S:
            cols = offs[:, t].long()[:, None] + w_ar[None, :]    # [G, Wn]
        else:
            cols = w_ar[None, :].expand(G, Wn)
        al = alleles[:, t].gather(1, cols).long()                # [G, Wn]
        wq = (weights[:, t].gather(1, cols)
              * np.float32(WEIGHT_SCALE)).to(i64)
        cov = al >= 0
        in_a = cov & (al < A)
        win = counts.gather(4, cols[:, None, None, None, :].expand(
            G, B, P, A, Wn))                                     # [G,B,P,A,Wn]
        maxc = win.max(dim=3).values                             # [G,B,P,Wn]
        at = win.gather(3, al.clamp(0, A - 1)[:, None, None, None, :]
                        .expand(G, B, P, 1, Wn)).squeeze(3)
        at = torch.where(in_a[:, None, None, :], at, 0)
        empty = maxc == 0
        c = cov[:, None, None, :]
        wqb = wq[:, None, None, :]
        same_q = (wqb * (c & ~empty & (at == maxc))).sum(-1)     # [G,B,P]
        diff_q = ((wqb * (c & ~empty & (at < maxc))).sum(-1)
                  + epsq[:, None, None] * (c & empty).sum(-1))
        same = same_q.to(f64) * INV_WEIGHT_SCALE
        diff = diff_q.to(f64) * INV_WEIGHT_SCALE
        pval = binom_tail(same + diff, diff, eps64[:, None, None],
                          constants.DIV_FACTOR)
        pa = part_active[:, None, :]
        pval = torch.where(pa, pval, -INF)
        lse = log_sum_exp(pval, dim=-1)                          # [G, B]
        keep = ((pval - lse[:, :, None]) > CUTOFF) & pa
        cand = torch.where(keep & live[:, :, None],
                           score[:, :, None] + diff_q.to(f64), INF)

        if dedup:
            # Reads >= t are unassigned (-1) in every slot; part -1 lands
            # in the scatter's extra column 0, which is dropped.
            hidx = (hist[:, :, :t].long() + 1)                   # [G,B,t]
            hv = []
            for f in range(zrows.shape[1]):
                zt = zrows[:, f, t, :t]                          # [G, t]
                rc = zrows[:, f, t, t]                           # [G]
                ph = torch.zeros((G, B, P + 1), dtype=i64, device=dev)
                ph = ph.scatter_add_(2, hidx, zt[:, None, :].expand(
                    G, B, t))[:, :, 1:] & MASK32                 # [G,B,P]
                # The reference sums its wrapped u32 products in u64
                # (x64 promotes the sum), so the P + 1 terms add without
                # a final wrap.
                base = _mul32(ph, gmix[f][None, None, :]).sum(-1)
                own = _mul32(gmix[f][None, :], rc[:, None])      # [G, P]
                hv.append((base[:, :, None] + own[:, None, :])
                          .reshape(G, N))
            flat = cand.reshape(G, N)
            finite = torch.isfinite(flat)
            gen = torch.arange(N, device=dev)
            eq = functools.reduce(torch.logical_and, [
                h[:, None, :] == h[:, :, None] for h in hv])
            dup = (eq & (gen[None, :] < gen[:, None])[None]
                   & finite[:, None, :]
                   & (flat[:, None, :] >= flat[:, :, None]))
            cand = torch.where(dup.any(dim=2).reshape(G, B, P), INF, cand)

        flat = torch.clamp(cand.reshape(G, N), max=BIG)
        order = torch.sort(flat, dim=1, stable=True).indices[:, :outs]
        sel_score = flat.gather(1, order)
        parent = order // P
        part = order % P
        o_ar = torch.arange(outs, device=dev)
        new_live = (o_ar[None, :] < width[:, None]) & (sel_score < BIG_CUT)
        new_score = torch.where(new_live, sel_score, INF)

        newc = counts.gather(1, parent[:, :, None, None, None].expand(
            G, outs, P, A, S))
        row_w = (al[:, None, :] == a_ar[None, :, None]).to(i64) \
            * wq[:, None, :]                                     # [G, A, Wn]
        row = torch.zeros((G, A, S), dtype=i64, device=dev).scatter_(
            2, cols[:, None, :].expand(G, A, Wn), row_w)
        part_oh = (part[:, :, None] == parts_ar[None, None, :]).to(i64)
        newc = newc + part_oh[:, :, :, None, None] * row[:, None, None]
        newh = hist.gather(1, parent[:, :, None].expand(G, outs, R))
        newh[:, :, t] = part.to(torch.int8)

        v = valid
        counts = torch.where(v[:, None, None, None, None], newc,
                             counts[:, :outs])
        hist = torch.where(v[:, None, None], newh, hist[:, :outs])
        score = torch.where(v[:, None], new_score, score[:, :outs])
        live = torch.where(v[:, None], new_live, live[:, :outs])
        rec_par = torch.where(v[:, None], parent, o_ar[None, :]).to(rec_dt)
        rec_prt = torch.where(v[:, None], part, -1).to(rec_dt)
        if t < T1:
            w_par.append(rec_par)
            w_prt.append(rec_prt)
        else:
            m_par.append(rec_par)
            m_prt.append(rec_prt)

    def stack(recs, n):
        if recs:
            return torch.stack(recs, dim=1)
        return torch.zeros((G, 0, n), dtype=rec_dt, device=dev)

    return BeamResult(stack(w_par, B1), stack(w_prt, B1), stack(m_par, W),
                      stack(m_prt, W), score, live)


def traceback_batch(result: BeamResult) -> torch.Tensor:
    """Plain twin of the reference's traceback_batch: walk each
    instance's best live slot (first index on ties) back through the
    main and warm records. [G, R] in the records' dtype."""
    wp, wt, mp, mt, scores, live = result
    b = torch.where(live, scores, INF).argmin(dim=1)[:, None]
    m_assign = [None] * mp.shape[1]
    for t in range(mp.shape[1] - 1, -1, -1):
        m_assign[t] = mt[:, t].gather(1, b)
        b = mp[:, t].gather(1, b).long()
    w_assign = [None] * wp.shape[1]
    for t in range(wp.shape[1] - 1, -1, -1):
        w_assign[t] = wt[:, t].gather(1, b)
        b = wp[:, t].gather(1, b).long()
    return torch.cat(w_assign + m_assign, dim=1)


def frontier_bounds(alleles: torch.Tensor, num_reads: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-read column bounds of K1's frontier, [G, R] int32 each:
    rstart[r], the read's first covered column (S when it covers none);
    lo[r], the least rstart of reads r..num_reads-1 (S past them); hi[r],
    the greatest end (last covered column + 1) of reads 0..r (reads past
    num_reads count as empty). No read >= r covers a column below lo[r],
    and no read <= r one at or above hi[r]."""
    G, R, S = alleles.shape
    covered = alleles >= 0
    has = covered.any(dim=-1)
    first = torch.argmax(covered.to(torch.uint8), dim=-1)
    last = S - 1 - torch.argmax(covered.flip(-1).to(torch.uint8), dim=-1)
    real = (torch.arange(R, device=alleles.device)[None, :]
            < num_reads.long()[:, None]) & has
    rstart = torch.where(has, first, torch.full_like(first, S))
    start = torch.where(real, first, torch.full_like(first, S))
    end = torch.where(real, last + 1, torch.zeros_like(last))
    lo = torch.flip(torch.cummin(torch.flip(start, [1]), dim=1).values, [1])
    hi = torch.cummax(end, dim=1).values
    return (rstart.to(torch.int32).contiguous(),
            lo.to(torch.int32).contiguous(), hi.to(torch.int32).contiguous())


def _window_cut(window: int) -> ValueError:
    return ValueError(
        f"beam_scan_cuda: a read extends past its window of {window} "
        "columns; K1 takes only windows that hold every read")


def _check_windows(alleles, num_reads, window: int) -> None:
    """K1 scores whole reads. The plain scan with a window < S scores
    only each read's window columns (the reference's `_window_offsets`);
    the two agree when every read lies inside its window, which the
    sweep's window policy guarantees (window >= span + 128 at 128-aligned
    offsets of sorted reads). Raise otherwise. Reads a flag from the
    device: the sweep checks on the host instead (`check_windows_host`)."""
    G, R, S = alleles.shape
    covered = alleles >= 0
    offs = _window_offsets(covered, S, window).long()
    cols = torch.arange(S, device=alleles.device)
    inside = (cols >= offs[..., None]) & (cols < offs[..., None] + window)
    real = (torch.arange(R, device=alleles.device)[None, :]
            < num_reads.long()[:, None])
    if bool((covered & ~inside & real[..., None]).any()):
        raise _window_cut(window)


def read_columns(alleles: np.ndarray, num_reads: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(first, last) covered column of each of a block's first
    `num_reads` rows ([R, S] alleles); last is -1 for a row that covers
    none."""
    cov = alleles[:num_reads] >= 0
    has = cov.any(axis=1)
    S = alleles.shape[1]
    first = np.where(has, cov.argmax(axis=1), S)
    last = np.where(has, S - 1 - cov[:, ::-1].argmax(axis=1), -1)
    return first, last


def check_windows_host(first: np.ndarray, last: np.ndarray, S: int,
                       window: int) -> None:
    """`_check_windows` for one block of a dispatch of S columns, on the
    host, from its reads' `read_columns` (S: the dispatch's padded
    width): numpy's copy of `_window_offsets`, the same raise."""
    if window >= S:
        return
    has = last >= 0
    start = np.where(has, first, S - 1)
    off = np.maximum.accumulate(np.minimum(start // 128 * 128, S - window))
    if (has & ((first < off) | (last >= off + window))).any():
        raise _window_cut(window)


# K1's dedup constants on the card, by (A, S, P, device): uploaded once.
_HASH_CONSTS: dict = {}
_hash_lock = threading.Lock()


def _hash_consts(A: int, S: int, P: int, dev) -> Tuple[torch.Tensor,
                                                        torch.Tensor]:
    """K1's u32 dedup constants as int32 tensors of the same bits on
    `dev`: hcol [S, F, A] (a column's constants contiguous), gmix
    [F, P]."""
    key = (A, S, P, dev)
    with _hash_lock:
        if key not in _HASH_CONSTS:
            hs, gs = state.dedup_hash_consts(A, S, P)
            _HASH_CONSTS[key] = tuple(
                upload(np.ascontiguousarray(x).view(np.int32), dev)
                for x in (np.stack(hs).transpose(2, 0, 1), np.stack(gs)))
        return _HASH_CONSTS[key]


def beam_scan_cuda(alleles, weights, num_reads, eps64, epsq, num_parts, *,
                   P: int, W: int, A: int, window: int, dedup: bool = True,
                   check_windows: bool = True
                   ) -> Tuple[BeamResult, torch.Tensor]:
    """K1 launch (csrc/beam_scan.cu): BeamResult plus the traceback
    assignments its epilogue writes. CUDA tensors only; arguments as
    `beam_scan_plain`'s first six, window already resolved (window >= S
    means full width). `check_windows=False` skips `_check_windows` (a
    host wait) for a caller that checked on the host; the call then
    never waits on the card."""
    G, R, S = alleles.shape
    dev = alleles.device
    if dev.type != "cuda":
        raise ValueError("beam_scan_cuda needs CUDA tensors")
    expect = {"alleles": (alleles, torch.int8, (G, R, S)),
              "weights": (weights, torch.float32, (G, R, S)),
              "num_reads": (num_reads, torch.int32, (G,)),
              "eps64": (eps64, torch.float64, (G,)),
              "epsq": (epsq, torch.int64, (G,)),
              "num_parts": (num_parts, torch.int32, (G,))}
    for name, (x, dt, shape) in expect.items():
        if x.device != dev or x.dtype != dt or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(
                f"beam_scan_cuda: {name} must be a contiguous {dt} "
                f"{shape} tensor on {dev}, got {x.dtype} "
                f"{tuple(x.shape)} on {x.device}")
    B1 = P * W
    if P > 127 or B1 * P > 4096 or A not in (2, 3, 4):
        raise ValueError(f"beam_scan_cuda: P={P}, W={W}, A={A} out of "
                         "range")
    if window < S and check_windows:
        _check_windows(alleles, num_reads, window)
    rstart, lo, hi = frontier_bounds(alleles, num_reads)
    hcol, gmix = _hash_consts(A, S, P, dev)
    T1 = min(constants.BEAM_WARMUP_READS, R)
    rec_dt = _rec_dtype(B1)
    Bf = W if R > T1 else B1
    counts = torch.empty((G, 2, B1, P, S, A), dtype=torch.int64, device=dev)
    wpar = torch.empty((G, T1, B1), dtype=rec_dt, device=dev)
    wprt = torch.empty_like(wpar)
    mpar = torch.empty((G, R - T1, W), dtype=rec_dt, device=dev)
    mprt = torch.empty_like(mpar)
    scores = torch.empty((G, Bf), dtype=torch.float64, device=dev)
    live = torch.empty((G, Bf), dtype=torch.uint8, device=dev)
    assign = torch.empty((G, R), dtype=rec_dt, device=dev)
    lib = _build.get_lib()
    ptr = ctypes.c_void_p
    # The C side sets kernel attributes and reads the SM count of the
    # current device: make it the tensors' card.
    with torch.cuda.device(dev):
        rc = lib.floria_beam_scan(
            *(ptr(x.data_ptr()) for x in (
                alleles, weights, num_reads, eps64, epsq, num_parts, rstart,
                lo, hi, hcol, gmix, counts, wpar, wprt, mpar, mprt, scores,
                live, assign)),
            G, R, S, P, A, W, T1, int(bool(dedup)),
            int(rec_dt == torch.int16), CUTOFF,
            ptr(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(rc, "beam_scan")
    _build.count_launch("beam_scan")
    return BeamResult(wpar, wprt, mpar, mprt, scores, live.bool()), assign


def cluster_width(G: int, device) -> int:
    """CTAs per instance K1 launches on `device` (a card) for a batch of
    G instances (1 when G fills the card)."""
    lib = _build.get_lib()
    with torch.cuda.device(device):
        return int(lib.floria_beam_cluster(G))


def _inputs(alleles, weights, num_reads, epsilon, num_parts, device):
    dev = resolve_device(device)

    def t(x, dt):
        return torch.as_tensor(x).to(device=dev, dtype=dt).contiguous()

    return (t(alleles, torch.int8), t(weights, torch.float32),
            t(num_reads, torch.int32), t(epsilon, torch.float32),
            t(num_parts, torch.int32))


def beam_search_traceback(alleles, weights, num_reads, epsilon, num_parts,
                          max_ploidy: int, beam_width: int,
                          max_alleles: int = constants.MAX_ALLELES,
                          window: int = 0, dedup: bool = True, *,
                          device, check_windows: bool = True
                          ) -> Tuple[BeamResult, torch.Tensor]:
    """Mixed-ploidy beam search over a batch of block instances, plus
    the best beam's [G, R] assignments. Inputs as the reference's
    beam_search_batch_mixed (alleles [G, R, S] int8, weights f32,
    num_reads [G], epsilon [G] f32, num_parts [G]); moved to `device`.
    On CUDA the scan and traceback run in K1; on the CPU in plain
    PyTorch. `check_windows` as `beam_scan_cuda` takes it."""
    check_no_tf32()
    alleles, weights, num_reads, epsilon, num_parts = _inputs(
        alleles, weights, num_reads, epsilon, num_parts, device)
    S = alleles.shape[-1]
    if window <= 0 or window >= S:
        window = S
    kw = dict(P=max_ploidy, W=beam_width, A=max_alleles, window=window,
              dedup=dedup)
    if alleles.device.type == "cuda":
        return beam_scan_cuda(alleles, weights, num_reads, *_eps(epsilon),
                              num_parts, check_windows=check_windows, **kw)
    eps64, epsq, offs, zrows, gmix = _prepare(
        alleles, weights, epsilon, max_alleles, max_ploidy, window, dedup)
    result = beam_scan_plain(alleles, weights, num_reads, eps64, epsq,
                             num_parts, offs, zrows, gmix, **kw)
    return result, traceback_batch(result)


def beam_search_batch_mixed(alleles, weights, num_reads, epsilon,
                            num_parts, max_ploidy: int, beam_width: int,
                            max_alleles: int = constants.MAX_ALLELES,
                            window: int = 0, dedup: bool = True, *,
                            device) -> BeamResult:
    """The reference's beam_search_batch_mixed on `device`."""
    return beam_search_traceback(
        alleles, weights, num_reads, epsilon, num_parts, max_ploidy,
        beam_width, max_alleles, window, dedup, device=device)[0]


def beam_search_batch(alleles, weights, num_reads, epsilon, ploidy: int,
                      beam_width: int,
                      max_alleles: int = constants.MAX_ALLELES,
                      window: int = 0, dedup: bool = True, *,
                      device) -> BeamResult:
    """The reference's beam_search_batch: every instance phased at the
    one `ploidy`, i.e. `beam_search_batch_mixed` with num_parts = ploidy
    and max_ploidy = ploidy (K1 on a card). A window (0 or >= S: full
    width) must hold every read: window >= the longest read span + 128."""
    num_parts = np.full(len(alleles), ploidy, np.int32)
    return beam_search_batch_mixed(alleles, weights, num_reads, epsilon,
                                   num_parts, ploidy, beam_width,
                                   max_alleles, window, dedup,
                                   device=device)


def traceback(result_g, num_reads: int, ploidy: int) -> np.ndarray:
    """The best beam's read -> part assignment of one instance (the
    reference's parent-chain walk, global_clustering.rs:149-178):
    `traceback_batch` on a batch of one. result_g: one instance's six
    records (warm_parents [T1, B1], warm_parts, main_parents [T2, W],
    main_parts, scores, live), tensors or arrays. Returns [num_reads]
    int32 on the host."""
    one = BeamResult(*((a if isinstance(a, torch.Tensor)
                        else torch.as_tensor(np.asarray(a)))[None]
                       for a in result_g))
    return traceback_batch(one)[0, :num_reads].cpu().numpy().astype(
        np.int32)
