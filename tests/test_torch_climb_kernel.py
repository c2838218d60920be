"""The climb kernel's plain version and its launch plan, on the CPU.

`upem_climb_plain` (the fixed-round climb over the plain move evaluation
and move function, which the card's climb kernel is held to) against the
JAX reference's `_upem_optimize_device_jit` on JAX's CPU backend, bitwise
on best, mec and diff: ploidies 2-6, 2-4 alleles, padding rows, instances
that converge in different rounds and ones that run all 20, R not a
multiple of 32 and S not a multiple of 8 (the cluster's column split).
Then the wrapper's pure-Python plan: the cluster width, the bytes per
instance, which of the counts and the move function's work arrays fills
their shared region, and when an instance takes the device scratch."""

import os
import re

import numpy as np
import pytest
import torch

from floria_tpu import constants as JC
from floria_tpu.kernels import upem_batch as U
from floria_tpu_torch import constants, state
from floria_tpu_torch.kernels import _build
from floria_tpu_torch.kernels import upem_batch as TU

# One intra-op thread: the suite runs several pytest workers on one
# host, and oversubscribed OpenMP threads slow every worker down.
torch.set_num_threads(1)

H100_SMS = 132
H100_SMEM_OPTIN = 232_448


def climb_case(R, S, P, A, seed, nreads, err=0.05, holes=0.0):
    """Reads of random spans drawn from P random haplotypes over alleles
    0..A-1 with errors (and a few cells of allele A, which covers but
    counts for no allele), phred weights (some qual 0), a random initial
    assignment with some -1 entries (a live row's -1 wraps to part P - 1
    in the move function, as the reference's indexing wraps it), padding
    rows
    past each instance's `nreads` (uncovered, assigned -1) and an epsilon
    per instance. With `holes`, that share of the covered cells is
    uncovered again and every third read gets a second segment, so reads
    have gaps inside their spans."""
    rng = np.random.default_rng(seed)
    G = len(nreads)
    hap = rng.integers(0, A, (G, P, S))
    origin = rng.integers(0, P, (G, R))
    alleles = np.full((G, R, S), -1, np.int8)
    quals = np.zeros((G, R, S), np.uint8)
    for g in range(G):
        for r in range(nreads[g]):
            s0 = int(rng.integers(0, S))
            s1 = min(S, s0 + int(rng.integers(max(1, S // 4), S + 1)))
            x = hap[g, origin[g, r], s0:s1].copy()
            flip = rng.random(s1 - s0) < err
            x[flip] = rng.integers(0, A, int(flip.sum()))
            alleles[g, r, s0:s1] = x
            quals[g, r, s0:s1] = rng.integers(0, 45, s1 - s0)
            if holes and r % 3 == 0:
                t0 = int(rng.integers(0, S))
                t1 = min(S, t0 + int(rng.integers(1, max(2, S // 8))))
                alleles[g, r, t0:t1] = hap[g, origin[g, r], t0:t1]
                quals[g, r, t0:t1] = rng.integers(0, 45, t1 - t0)
    if holes:
        alleles[rng.random(alleles.shape) < holes] = -1
    alleles[(alleles >= 0) & (rng.random(alleles.shape) < 0.005)] = A
    weights = state.phred_table()[quals]
    assign = rng.integers(0, P, (G, R)).astype(np.int32)
    assign[rng.random((G, R)) < 0.02] = -1
    for g in range(G):
        assign[g, nreads[g]:] = -1
    eps = rng.choice([0.01, 0.02, 0.03, 0.05], G).astype(np.float32)
    return alleles, weights, assign, np.asarray(nreads, np.int32), eps


# (R, S, P, A, seed, nreads): instance 0 of the first three runs all 20
# rounds (hundreds of reads from a random start), the small ones stop
# earlier and at different rounds.
CASES = [
    (300, 61, 2, 2, 1, [300, 40, 70, 9]),
    (300, 45, 3, 3, 4, [296, 33, 64, 2]),
    (300, 61, 4, 4, 6, [300, 50, 17, 31]),
    (70, 45, 3, 3, 4, [70, 69, 50, 33, 12, 1]),
    (33, 29, 4, 4, 5, [33, 30, 28, 20, 9]),
    (50, 61, 5, 2, 6, [50, 49, 48, 40, 25, 0]),
    (45, 19, 6, 3, 7, [45, 44, 30, 7]),
    (96, 130, 2, 4, 8, [96, 95, 60]),
    (40, 37, 5, 4, 9, [40, 38, 22]),
    (64, 200, 6, 2, 10, [64, 61, 3]),
]


@pytest.mark.parametrize("R,S,P,A,seed,nreads", CASES)
def test_climb_plain_matches_jax(R, S, P, A, seed, nreads):
    alleles, weights, assign, nr, eps = climb_case(R, S, P, A, seed, nreads)
    want = U.upem_optimize_device(alleles, weights, assign, nr, eps, P,
                                  max_alleles=A)
    evals = torch.zeros(len(nreads), dtype=torch.int64)
    got = TU.upem_climb_plain(
        *(torch.from_numpy(x) for x in (alleles, weights, assign, nr, eps)),
        P, A, evaluations=evals)
    for name, a, b in zip(("best", "mec", "diff"), want, got):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype, name
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
    # The CPU route of the main path's entry stops early, with the same
    # results.
    entry = TU.upem_optimize_device(alleles, weights, assign, nr, eps, P,
                                    A, device="cpu")
    for a, b in zip(got, entry):
        assert torch.equal(a, b)
    ev = evals.tolist()
    assert all(0 <= e <= constants.NUM_ITER_OPTIMIZE for e in ev)
    if nreads[0] >= 296:
        assert ev[0] == constants.NUM_ITER_OPTIMIZE, ev
        assert len(set(ev)) >= 3, ev


def test_climb_kernel_rounds_are_the_references():
    """The climb kernel's round cap, a constant of its source, is the
    reference's NUM_ITER_OPTIMIZE (the plain climb runs that many)."""
    with open(os.path.join(_build.CSRC_DIR, "upem_eval.cu")) as fh:
        found = re.findall(r"constexpr int NUM_ITER_OPTIMIZE = (\d+);",
                           fh.read())
    assert [int(n) for n in found] == [JC.NUM_ITER_OPTIMIZE]
    assert constants.NUM_ITER_OPTIMIZE == JC.NUM_ITER_OPTIMIZE


def test_climb_plain_rounds_differ_between_instances():
    """The evaluation counts the smoke run's bound uses: a converged
    instance stops counting, so instances differ."""
    seen = set()
    for R, S, P, A, seed, nreads in CASES[3:7]:
        args = climb_case(R, S, P, A, seed, nreads)
        evals = torch.zeros(len(nreads), dtype=torch.int64)
        TU.upem_climb_plain(*(torch.from_numpy(x) for x in args), P, A,
                            evaluations=evals)
        seen.update(evals.tolist())
    assert len(seen) >= 4, seen


@pytest.mark.parametrize("G,S,want", [
    (8, 2048, 8),      # the kernel sweep: 256 columns per CTA
    (115, 2048, 1),    # the ecoli2 dispatch fills the card
    (66, 2048, 2), (67, 2048, 1), (33, 2048, 4), (16, 2048, 8),
    (26, 1024, 4), (22, 1024, 4),   # config4's largest dispatches
    (8, 256, 2), (8, 255, 2), (8, 254, 1), (8, 128, 1), (1, 61, 1),
])
def test_climb_cluster_width(G, S, want):
    """K1's rule (2 * G * width within 132 SMs, width <= 8), cut so a CTA
    keeps at least 128 columns."""
    assert TU.climb_cluster_width(G, S, H100_SMS) == want


def _plan(G, R, S, P, A, **kw):
    return TU.climb_plan(G, R, S, P, A, H100_SMS, H100_SMEM_OPTIN, **kw)


@pytest.mark.parametrize("G,R,S,P,A,C,stride,counts_fill,shared", [
    # The kernel sweep at P = 5 (G = 8 gives clusters of 8; C = 1 forced):
    # the counts (160 KB) fill the region, K4's work (15.3 KB) aliases
    # them.
    (8, 320, 2048, 5, 2, 1, 193_280, True, True),
    (8, 320, 2048, 5, 2, 8, 53_760, True, True),
    # config4's largest level-5 dispatch, R = 192, S = 1024.
    (26, 192, 1024, 5, 2, 4, 40_960, True, True),
    (26, 192, 1024, 5, 2, 1, 98_560, True, True),
    # The ecoli2 dispatch at P = 2 and P = 3.
    (115, 256, 2048, 2, 2, 1, 78_848, True, True),
    (115, 256, 2048, 3, 2, 1, 115_712, True, True),
    # Four alleles at S = 2048: P = 3 still fits, P >= 4 takes the
    # scratch unless a cluster splits the columns.
    (115, 256, 2048, 3, 4, 1, 214_016, True, True),
    (115, 256, 2048, 4, 4, 1, 283_648, True, False),
    (115, 256, 2048, 6, 4, 1, 422_912, True, False),
    (8, 256, 2048, 6, 4, 8, 80_384, True, True),
    # Many reads over few columns: the move function's work arrays
    # (12 bytes per candidate) outgrow the counts and set the region.
    (4, 6000, 64, 5, 2, 1, 654_320, False, False),
    (4, 1500, 256, 3, 2, 1, 104_272, False, True),
])
def test_climb_layout_and_route(G, R, S, P, A, C, stride, counts_fill,
                                shared):
    forced = {} if TU.climb_cluster_width(G, S, H100_SMS) == C else {
        "cluster": C}
    c, lay, in_shared, arr = _plan(G, R, S, P, A, **forced)
    assert c == C
    assert lay.stride == stride
    assert (lay.counts >= lay.moves) == counts_fill
    assert in_shared == shared
    assert list(arr) == [lay.head, lay.part, lay.best, lay.prop, lay.rows,
                         lay.span, lay.mask, lay.uni, lay.stride]
    # Every array 16-byte aligned and in order; the per-CTA columns a
    # multiple of 4 covering S.
    offs = [lay.best, lay.prop, lay.rows, lay.span, lay.mask, lay.uni,
            lay.stride]
    assert all(o % 16 == 0 for o in offs + [lay.part, lay.head])
    assert offs == sorted(offs)
    assert lay.Sc % 4 == 0 and lay.Sc * C >= S > lay.Sc * (C - 1) - 4
    assert lay.part == (0 if C == 1 else lay.best // 2)
    assert lay.stride - lay.uni >= max(lay.counts, lay.moves)


def test_climb_plan_forcing_and_cache():
    """`cluster` and `shared` force a route; a plan is worked out once per
    shape."""
    a = _plan(8, 320, 2048, 5, 2)
    assert a is _plan(8, 320, 2048, 5, 2)
    assert a[0] == 8 and a[2]
    c, _lay, shared, _arr = _plan(8, 320, 2048, 5, 2, cluster=2,
                                  shared=False)
    assert (c, shared) == (2, False)
    assert TU.climb_layout(320, 2048, 5, 2, 2).Sc == 1024
    assert TU.climb_layout(40, 37, 5, 4, 8).Sc == 8    # ceil(37/8) -> 8
    assert TU.climb_layout(40, 37, 5, 4, 2).Sc == 20   # 19 -> 20


def test_climb_wrapper_refuses_cpu_tensors_and_wide_alleles():
    args = [torch.from_numpy(x) for x in climb_case(8, 8, 2, 2, 0, [8])]
    with pytest.raises(ValueError):
        TU.upem_climb_cuda(*args, 2, 2)
