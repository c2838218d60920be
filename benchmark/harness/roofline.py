"""The yardstick of the kernel metrics: the H100's published peaks and the
bytes and operations of K1 (the beam scan) on the harness's own blocks.

Frozen copies of the repository's counts, counted per (block, ploidy)
instance on the blocks as generated, not on the program's padded buckets:

- bytes (bench.py `k1_cost`): each input read once and each output
  written once: alleles (1 B) and weights (4 B) over each read's covered
  span, 24 B per instance, the parent and part records of every step,
  the final scores, live flags and assignments;
- operations (scripts/mfu.py `k1_work`): the beam's own work per scan
  step, for B slots in and `out` slots out over P parts and c covered
  columns: scoring 2 * B * P * c, prune 4 * B * P, dedup 3 * B * P,
  select B * P * ceil(log2(out)), update out * c. The first 25 reads
  keep P * W slots, later reads W.
"""

from __future__ import annotations

import math

import numpy as np

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the float32 rate outside
# the tensor cores, at which K1's scalar integer operations are counted.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
T1 = 25


def k1_bytes(alleles: np.ndarray, P: int, W: int) -> int:
    """K1's bytes for one instance: alleles [R, S] (-1 = uncovered)."""
    R, _S = alleles.shape
    cov = alleles >= 0
    has = cov.any(1)
    first = cov.argmax(1)
    last = cov.shape[1] - 1 - cov[:, ::-1].argmax(1)
    span = int((last - first + 1)[has].sum())
    t1 = min(T1, R)
    rec = 1 if P * W <= 127 else 2
    bf = W if R > t1 else P * W
    return (span * 5 + 24
            + (2 * t1 * P * W + 2 * (R - t1) * W + R) * rec + bf * 9)


def _step_ops(B: int, P: int, c: np.ndarray, out: int) -> np.ndarray:
    n = B * P
    return (2 * n * c + 4 * n + 3 * n + n * math.ceil(math.log2(out))
            + out * c)


def k1_ops(alleles: np.ndarray, P: int, W: int) -> int:
    """The beam's operations for one instance of `alleles` at ploidy P."""
    c = (alleles >= 0).sum(1).astype(np.int64)
    R = len(c)
    warm = min(T1, R)
    total = int(_step_ops(P * W, P, c[:warm], P * W).sum())
    if R > T1:
        total += int(_step_ops(P * W, P, c[T1:T1 + 1], W).sum())
        total += int(_step_ops(W, P, c[T1 + 1:], W).sum())
    return total


def k1_bound_s(blocks, ploidies, W: int) -> float:
    """The least time K1 can take over every (block, ploidy) instance of
    one call: the larger of its bytes over the HBM rate and its
    operations over the scalar rate."""
    nbytes = sum(k1_bytes(al, P, W) for al, _q in blocks for P in ploidies)
    ops = sum(k1_ops(al, P, W) for al, _q in blocks for P in ploidies)
    return max(nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S)
