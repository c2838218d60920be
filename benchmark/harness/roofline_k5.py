"""The yardstick of k5.roofline_pct: the bytes and operations of K5 (the
realignment NW, csrc/nw_best.cu) on the job partitions the program hands
it, from the program's own counts in its `realign.device.nw_best` spans.

A frozen copy of the repository's count (chip_smoke.py `k5_bound`):

- bytes: the jobs and tables read once (the `h2d_bytes` the program
  counts for their uploads) and one byte written per job (`nw_jobs`);
- operations: ten integer operations per cell of the reference's full
  32 x 32 DP (alignment.rs) for each allele a job tries (`nw_alleles`,
  the sum of min(nal, a_max)), whatever the kernel itself does.
"""

from __future__ import annotations

from .roofline import HBM_BYTES_PER_S, SCALAR_OPS_PER_S

WINDOW = 32
OPS_PER_CELL = 10


def k5_bound_s(h2d_bytes: float, jobs: float, alleles: float) -> float:
    """The least time K5 can take on one partition: the larger of its
    bytes (`h2d_bytes` read, one byte a job written) over the HBM rate
    and its operations over the scalar rate."""
    return max((h2d_bytes + jobs) / HBM_BYTES_PER_S,
               OPS_PER_CELL * WINDOW * WINDOW * alleles / SCALAR_OPS_PER_S)
