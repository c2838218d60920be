"""The port's CUDA kernels against their plain PyTorch versions on the
same card, bitwise: K1 (beam scan + traceback), K4 (the UPEM move
function: candidates, sort and walk; with and without its `active`
mask), K5 (realignment NW, two alleles per DP) and K6 (UPEM move
evaluation: init, step and unit MEC; the climb kernel, over its routes,
against the plain climb, in one launch with no host wait); the climb on
the card against the CPU, and a sweep level enqueued without a host
wait; the sharded beam and sweep (parallel/mesh.py) against the
unsharded run, two shards on one card, and on two cards where a machine
has them; and the port's CLI on the card against the JAX package's
pipeline on JAX's CPU backend, in one process, on the round's small
configs; and the port's decisions on the main path's own recorded calls
against the JAX package on JAX's CPU backend (the holds of
tests/test_torch_decisions_a.py): every sweep block by block, every K1
beam dispatch, K6 climb and fused level 2's ploidy-1 MEC instance by
instance, on the 13 North-star configs, ecoli2 (and its largest
dispatch at P=3) and multi500; and K5 at ecoli2's partition job by job
(best allele and scores). Those run with

    python -m pytest tests/test_torch_cuda.py -m cuda -q -s -k decisions

CUDA kernels have no CPU mode, so these tests need a card and skip
without one (decided inside the fixture). On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from chip_smoke import (dedup_case, nvidia_smi_line, nw_case, windowed_case,
                        workload_blocks)
from floria_tpu_torch import entry, state
from floria_tpu_torch.kernels import _build
from floria_tpu_torch.kernels import beam as TB
from floria_tpu_torch.kernels import realign as TR
from floria_tpu_torch.kernels import upem_batch as TU
from floria_tpu_torch.parallel import mesh as TM
from floria_tpu_torch.phase import local as TL
from test_beam_pallas import _make
from test_torch_decisions_a import (hold_counts, jax_nw_flips, record_config,
                                    record_run)
from test_torch_oracle_configs import SMALL, run_both
from test_torch_climb_kernel import CASES as CLIMB_CASES, climb_case
from test_torch_upem import CASES, _batch, moves_case

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _kernel_vs_plain(dev, alleles, weights, nreads, eps, nparts, P, W,
                     A=2, window=0, dedup=True):
    """(kernel result, kernel assignments, plain result, plain
    assignments), all on `dev`."""
    al, wt, nr, ep, npt = TB._inputs(alleles, weights, nreads, eps,
                                     nparts, dev)
    S = al.shape[-1]
    window = S if window <= 0 or window >= S else window
    prep = TB._prepare(al, wt, ep, A, P, window, dedup)
    args = (al, wt, nr, *prep[:2], npt, *prep[2:])
    kw = dict(P=P, W=W, A=A, window=window, dedup=dedup)
    got, asg = TB.beam_scan_cuda(*args[:6], **kw)
    ref = TB.beam_scan_plain(*args, **kw)
    torch.cuda.synchronize()
    return got, asg, ref, TB.traceback_batch(ref)


def _assert_same(got, asg, ref, ref_asg):
    for name, a, b in zip(ref._fields + ("assign",), tuple(ref) + (ref_asg,),
                          tuple(got) + (asg,)):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name


def _random_case(G, R, S, P, seed, nparts, A=2):
    alleles, weights = _make(G, R, S, P, seed, A=A)
    nreads = np.array([R - (g % 7) for g in range(G)], np.int32)
    return (alleles, weights, nreads, np.full(G, 0.03, np.float32),
            np.asarray(nparts, np.int32))


@pytest.mark.parametrize("G,R,S,P,W,seed,nparts,A", [
    (3, 40, 64, 3, 10, 0, (3, 2, 3), 2),     # mixed parts, padded reads
    (2, 60, 128, 5, 10, 2, (5, 4), 2),
    (4, 20, 64, 2, 10, 3, (2, 2, 2, 2), 2),  # R <= warm-up: no main records
    (2, 40, 64, 5, 30, 4, (5, 3), 2),        # B1 = 150: int16 records
    (2, 50, 64, 3, 10, 5, (3, 2), 4),        # four alleles
    (1, 2100, 48, 2, 3, 6, (2,), 2),         # R > 2048
])
def test_beam_kernel_matches_plain(dev, G, R, S, P, W, seed, nparts, A):
    # G < 66: every case runs K1's thread-block-cluster path.
    assert TB.cluster_width(G, dev) > 1
    got, asg, ref, ref_asg = _kernel_vs_plain(
        dev, *_random_case(G, R, S, P, seed, nparts, A), P, W, A=A)
    _assert_same(got, asg, ref, ref_asg)


@pytest.mark.parametrize("G,A,width", [(70, 2, 1), (40, 4, 2), (20, 3, 4)])
def test_beam_kernel_cluster_widths_match_plain(dev, G, A, width):
    """G = 70 fills the card with one CTA per instance (no cluster);
    G = 40 and 20 take clusters of two and four. Mixed parts, padded
    reads, two to four alleles."""
    nparts = [2 + g % 4 for g in range(G)]
    assert TB.cluster_width(G, dev) == width
    got, asg, ref, ref_asg = _kernel_vs_plain(
        dev, *_random_case(G, 48, 256, 5, 7 + G, nparts, A), 5, 10, A=A)
    _assert_same(got, asg, ref, ref_asg)


@pytest.mark.parametrize("G", [3, 70])
def test_beam_kernel_without_dedup_matches_plain(dev, G):
    got, asg, ref, ref_asg = _kernel_vs_plain(
        dev, *_random_case(G, 40, 64, 3, G, [3 - g % 2 for g in range(G)]),
        3, 10, dedup=False)
    _assert_same(got, asg, ref, ref_asg)


def test_beam_kernel_rejects_a_window_that_cuts_a_read(dev):
    *inp, P = windowed_case(G=2, R=80, S=1024, span=120)
    with pytest.raises(ValueError, match="window"):
        _kernel_vs_plain(dev, *inp, P, 10, window=128)


def test_beam_kernel_windowed_matches_plain_and_full(dev):
    *inp, P = windowed_case(G=2, R=80, S=1024, span=120)
    win = _kernel_vs_plain(dev, *inp, P, 10, window=256)
    _assert_same(*win)
    full = _kernel_vs_plain(dev, *inp, P, 10)
    for name, a, b in zip(win[0]._fields, win[0], full[0]):
        assert torch.equal(a, b), name
    assert torch.equal(win[1], full[1])


def test_beam_kernel_dedup_case_matches_plain(dev):
    *inp, P = dedup_case()
    _assert_same(*_kernel_vs_plain(dev, *inp, P, 10))


def _moves_kernel_vs_plain(dev, assign, diff, nreads):
    t = [torch.as_tensor(x).to(dev) for x in (assign, diff, nreads)]
    got = TU.apply_moves_cuda(*t)
    torch.cuda.synchronize()
    want = TU.apply_moves_plain(*t)
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("ploidy,seed", [(2, 0), (3, 1), (5, 2)])
def test_move_walk_kernel_matches_plain(dev, ploidy, seed):
    """K4 as the whole move function on the first UPEM iteration's input
    (the beam's assignments) and on a later one (after a walk)."""
    args = _random_case(6, 64, 128, ploidy, seed, [ploidy] * 6)
    al, wt, nr, ep, npt = TB._inputs(*args, dev)
    _res, asg = TB.beam_search_traceback(al, wt, nr, ep, npt, ploidy, 10,
                                         max_alleles=2, device=dev)
    assign = asg.to(torch.int32).contiguous()
    for _it in range(2):
        diff, _score = TU._eval_diff_score(al, wt, assign, ep, ploidy, 2)
        assign = _moves_kernel_vs_plain(dev, assign, diff.contiguous(), nr)


@pytest.mark.parametrize("case", ["ties", "no_valid", "equal_gains",
                                  "padding", "large_shared"])
@pytest.mark.parametrize("P", [2, 3, 5])
def test_move_kernel_edge_cases_match_plain(dev, case, P):
    R = 2100 if case == "large_shared" else 48
    assign, diff, nreads = moves_case(6, R, P, 7 * P + len(case))
    if case == "no_valid":
        diff[:] = 4096.0        # no positive gain anywhere
    elif case == "equal_gains":
        diff[:] = 8192.0
        diff[np.arange(6)[:, None], np.arange(R)[None, :],
             np.clip(assign, 0, P - 1)] = 3 * 8192.0
    elif case == "padding":
        nreads[:] = [0, 1, 2, R // 3, R - 1, R]
        for g in range(6):
            assign[g, nreads[g]:] = -1
    got = _moves_kernel_vs_plain(dev, assign, diff, nreads)
    if case == "no_valid":
        assert np.array_equal(got.cpu().numpy(), assign)
    if case == "large_shared":   # over 48 KB of dynamic shared memory
        assert sum(TU.moves_layout(R, P)[1:]) > 48 * 1024 or P == 2
        assert TU.moves_in_shared(R, P, dev)


def test_move_kernel_global_scratch_path_matches_plain(dev):
    """R * (P - 1) candidates too many for shared memory: the same kernel
    sorts in a device-memory scratch."""
    R, P = 6000, 5
    assert not TU.moves_in_shared(R, P, dev)
    _moves_kernel_vs_plain(dev, *moves_case(4, R, P, 11, levels=40))


def test_wrappers_count_launches_and_check_inputs(dev):
    args = _random_case(2, 30, 32, 2, 1, (2, 2))
    _build.LAUNCHES.clear()
    TB.beam_search_traceback(*args, 2, 10, max_alleles=2, device=dev)
    assert _build.LAUNCHES["beam_scan"] == 1
    assign = torch.zeros((2, 30), dtype=torch.int32, device=dev)
    diff = torch.zeros((2, 30, 2), dtype=torch.float64, device=dev)
    num_reads = torch.full((2,), 30, dtype=torch.int32, device=dev)
    for bad in ((assign.long(), diff, num_reads),
                (assign, diff.float(), num_reads),
                (assign, diff.transpose(0, 1).contiguous().transpose(0, 1),
                 num_reads),
                (assign, diff, num_reads[:1]),
                (assign.cpu(), diff, num_reads)):
        with pytest.raises(ValueError):
            TU.apply_moves_cuda(*bad)
    assert _build.LAUNCHES["upem_moves"] == 0
    TU.apply_moves_cuda(assign, diff, num_reads)
    assert _build.LAUNCHES["upem_moves"] == 1
    TU.apply_moves(assign, diff.transpose(1, 2).contiguous().transpose(1, 2),
                   num_reads.long())
    assert _build.LAUNCHES["upem_moves"] == 2


@pytest.mark.parametrize("n,A,a_max,nal_set", [
    (1, 2, 2, 0), (1, 4, 4, 1), (1, 4, 4, None),
    (1000, 2, 2, None),      # 1000 = 7 blocks of 128 + 104
    (1000, 4, 4, None),      # nal 0..4
    (333, 4, 2, None),       # the biallelic partition of a 4-column table
    (1000, 4, 1, None),      # one allele: a dummy high lane
    (1000, 4, 3, None),      # odd a_max: (0, 1) then (2, dummy)
    (1000, 3, 3, None),
    (1000, 4, 3, 2),         # nal < a_max everywhere
    (1000, 4, 4, 3),
])
def test_nw_kernel_matches_plain(dev, n, A, a_max, nal_set):
    q, si, nal, ref_tab, al_tab = nw_case(n=n, T=97, A=A, seed=n + A)
    if nal_set is not None:
        nal[:] = nal_set
    t = [torch.from_numpy(x).to(dev) for x in (q, si, nal, ref_tab, al_tab)]
    scores = torch.empty((n, a_max), dtype=torch.int32, device=dev)
    got = TR.nw_best_cuda(*t, a_max, scores=scores)
    torch.cuda.synchronize()
    assert torch.equal(got, TR.nw_best_plain(*t, a_max))
    assert torch.equal(scores, TR.nw_allele_scores_plain(*t, a_max))
    if a_max == A:
        assert np.array_equal(got.cpu().numpy(),
                              TR.native.nw_batch(q, si, nal, ref_tab, al_tab))


def test_nw_kernel_extreme_windows_match_plain_and_cpp(dev):
    """Windows that drive the scores toward NEG: every base a mismatch,
    and a query shifted by 16 bases (long gaps), at four alleles."""
    q, si, nal, ref_tab, al_tab = nw_case(n=400, T=40, A=4, seed=9)
    rng = np.random.default_rng(9)
    ref_tab[:] = 1
    al_tab[:] = rng.integers(1, 16, al_tab.shape)
    qu = np.full((400, 32), 2, np.uint8)
    for i in range(1, 400, 2):
        qu[i] = np.concatenate([rng.integers(3, 16, 16), np.ones(16)])
    q = (qu[:, 0::2] | (qu[:, 1::2] << 4)).astype(np.uint8)
    nal[:] = 4
    t = [torch.from_numpy(x).to(dev) for x in (q, si, nal, ref_tab, al_tab)]
    scores = torch.empty((400, 4), dtype=torch.int32, device=dev)
    got = TR.nw_best_cuda(*t, 4, scores=scores)
    torch.cuda.synchronize()
    want_sc = TR.nw_allele_scores_plain(*t, 4)
    assert torch.equal(scores, want_sc)
    assert int(want_sc[0::2].max()) <= -20
    assert torch.equal(got, TR.nw_best_plain(*t, 4))
    assert np.array_equal(got.cpu().numpy(),
                          TR.native.nw_batch(q, si, nal, ref_tab, al_tab))


def test_nw_wrapper_counts_launches_and_checks_inputs(dev):
    q, si, nal, ref_tab, al_tab = (torch.from_numpy(x).to(dev)
                                   for x in nw_case(n=50, A=2))
    _build.LAUNCHES.clear()
    with pytest.raises(ValueError):
        TR.nw_best(q, si.long(), nal, ref_tab, al_tab, 2)
    with pytest.raises(ValueError):
        TR.nw_best(q, si, nal, ref_tab, al_tab, 3)
    with pytest.raises(ValueError):
        TR.nw_best(q, si + len(ref_tab), nal, ref_tab, al_tab, 2)
    assert _build.LAUNCHES["nw_best"] == 0
    got = TR.nw_best(q, si, nal, ref_tab, al_tab, 2)
    assert _build.LAUNCHES["nw_best"] == 1
    assert got.device.type == "cuda" and got.dtype == torch.int8


def eval_case(G, R, S, P, A, seed):
    """K6 inputs: reads of random spans with alleles 0..A-1 (a few cells
    of allele A, which covers but counts for no allele), phred weights
    (some of qual 0: covered, zero weight), assignments mostly in
    [0, P) with some -1 and P (out of range), padding rows past
    num_reads (uncovered, assigned -1), and an epsilon per instance."""
    rng = np.random.default_rng(seed)
    alleles = np.full((G, R, S), -1, np.int8)
    quals = np.zeros((G, R, S), np.uint8)
    nreads = np.array([R - g % 4 for g in range(G)], np.int32)
    for g in range(G):
        for r in range(nreads[g]):
            s0 = int(rng.integers(0, S))
            s1 = min(S, s0 + int(rng.integers(1, max(2, S // 2))))
            alleles[g, r, s0:s1] = rng.integers(0, A, s1 - s0)
            quals[g, r, s0:s1] = rng.integers(0, 50, s1 - s0)
    alleles[(alleles >= 0) & (rng.random(alleles.shape) < 0.01)] = A
    weights = state.phred_table()[quals]
    assign = rng.integers(0, P, (G, R)).astype(np.int32)
    assign[rng.random((G, R)) < 0.03] = -1
    assign[rng.random((G, R)) < 0.02] = P
    for g in range(G):
        assign[g, nreads[g]:] = -1
    eps = rng.choice([0.01, 0.02, 0.03, 0.05], G).astype(np.float32)
    return alleles, weights, assign, nreads, eps


def _eval_kernel_vs_plain(dev, alleles, weights, assign, nreads, eps, P, A):
    """K6's three modes against upem_eval_plain on the same card. The
    step runs on instances of four kinds (g % 4): a proposal that
    improves (accepted), one that is worse (rejected), one equal to
    `best` (unchanged) and an inactive instance. Returns the flags after
    the step."""
    al, wt, asg, nr, ep = (torch.as_tensor(x).to(dev) for x in (
        alleles, weights, assign, nreads, eps))
    got = TU.upem_eval_cuda("init", al, wt, asg, ep, P, A)
    torch.cuda.synchronize()
    want = TU.upem_eval_plain("init", al, wt, asg, ep, P, A)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and torch.equal(a, b)
    mec = TU.upem_eval_cuda("mec", al, wt, asg, ep, P, A)
    assert torch.equal(mec, TU.upem_eval_plain("mec", al, wt, asg, ep, P, A))

    refined = TU.upem_optimize_device(al, wt, asg, nr, ep, P, A,
                                      device=dev)[0]
    kind = torch.arange(len(assign), device=dev) % 4
    best = torch.where((kind == 1)[:, None] | (kind == 2)[:, None], refined,
                       asg).contiguous()
    proposal = torch.where((kind == 1)[:, None], asg, refined).contiguous()
    diff, score, _a = TU.upem_eval_plain("init", al, wt, best, ep, P, A)
    active = kind != 3
    states = [tuple(x.clone() for x in (best, score, diff, active))
              for _ in range(2)]
    TU.upem_eval_cuda("step", al, wt, proposal, ep, P, A, states[0])
    torch.cuda.synchronize()
    TU.upem_eval_plain("step", al, wt, proposal, ep, P, A, states[1])
    for a, b in zip(*states):
        assert torch.equal(a, b)
    moved = (refined != asg).any(dim=1)
    assert torch.equal(states[1][3], (kind == 0) & moved)
    return states[1][3]


@pytest.mark.parametrize("path", ["shared", "scratch"])
@pytest.mark.parametrize("A", [2, 3, 4])
@pytest.mark.parametrize("P", [2, 3, 4, 5, 6])
def test_eval_kernel_matches_plain(dev, P, A, path, monkeypatch):
    """K6 at P = 2..6 and A = 2..4, its counts in shared memory and (the
    same kernel, forced) in a device scratch."""
    if path == "scratch":
        monkeypatch.setattr(TU, "eval_in_shared", lambda *_a: False)
    else:
        assert TU.eval_in_shared(48, 256, P, A, dev)
    # A step accepts somewhere within a few seeds (a climb from a random
    # assignment may not move at all).
    accepted = False
    for seed in range(10 * P + A, 10 * P + A + 4):
        args = eval_case(8, 48, 256, P, A, seed=seed)
        accepted = bool(_eval_kernel_vs_plain(dev, *args, P, A).any())
        if accepted:
            break
    assert accepted


def test_eval_kernel_scratch_when_counts_exceed_shared_memory(dev):
    """A column count too large for shared memory (S = 2048 at P = 6,
    A = 4: 393 KB of counts) takes the scratch path without forcing."""
    assert not TU.eval_in_shared(24, 2048, 6, 4, dev)
    assert TU.eval_in_shared(24, 2048, 5, 2, dev)
    _eval_kernel_vs_plain(dev, *eval_case(4, 24, 2048, 6, 4, seed=5), 6, 4)


@pytest.mark.parametrize("path", ["shared", "scratch"])
@pytest.mark.parametrize("A", [2, 3, 4])
def test_eval_kernel_mec_at_ploidy_one_matches_plain(dev, A, path,
                                                     monkeypatch):
    """K6's mec mode at P = 1, as the fused 1+2 sweep level launches it
    (every row in part 0), and with eval_case's assignments at P = 1
    (some -1 and 1: out of range), on both routes."""
    if path == "scratch":
        monkeypatch.setattr(TU, "eval_in_shared", lambda *_a: False)
    else:
        assert TU.eval_in_shared(48, 256, 1, A, dev)
    al, wt, asg, _nr, ep = (torch.as_tensor(x).to(dev) for x in eval_case(
        8, 48, 256, 1, A, seed=90 + A))
    for assign in (torch.zeros_like(asg), asg):
        got = TU.upem_eval_cuda("mec", al, wt, assign, ep, 1, A)
        torch.cuda.synchronize()
        assert torch.equal(got, TU.upem_eval_plain("mec", al, wt, assign, ep,
                                                   1, A))


def test_eval_wrapper_counts_launches_and_checks_inputs(dev):
    al, wt, asg, _nr, ep = (torch.as_tensor(x).to(dev) for x in eval_case(
        2, 16, 64, 2, 2, seed=1))
    _build.LAUNCHES.clear()
    for bad in ((al.long(), wt, asg, ep), (al, wt.double(), asg, ep),
                (al, wt, asg.long(), ep), (al, wt, asg, ep[:1]),
                (al, wt, asg.t().contiguous().t(), ep),
                (al.cpu(), wt, asg, ep)):
        with pytest.raises(ValueError):
            TU.upem_eval_cuda("init", *bad, 2, 2)
    with pytest.raises(ValueError):
        TU.upem_eval_cuda("climb", al, wt, asg, ep, 2, 2)
    diff, score, active = TU.upem_eval_cuda("init", al, wt, asg, ep, 2, 2)
    with pytest.raises(ValueError):
        TU.upem_eval_cuda("step", al, wt, asg, ep, 2, 2,
                          (asg, score, diff, active.to(torch.uint8)))
    assert _build.LAUNCHES["upem_eval"] == 1
    TU.upem_eval("step", al, wt, asg, ep, 2, 2, (asg, score, diff, active))
    TU.upem_eval("mec", al, wt, asg, ep, 2, 2)
    assert _build.LAUNCHES["upem_eval"] == 3


@pytest.mark.parametrize("P,R", [(2, 48), (3, 48), (5, 48), (5, 6000)])
def test_masked_move_kernel_matches_plain(dev, P, R):
    """K4 with an `active` mask (R = 6000 at P = 5: the scratch path):
    inactive instances propose their assignment unchanged."""
    assign, diff, nreads = moves_case(6, R, P, 3 * P + R, levels=40)
    t = [torch.as_tensor(x).to(dev) for x in (assign, diff, nreads)]
    active = torch.tensor([True, False, True, True, False, True], device=dev)
    got = TU.apply_moves_cuda(*t, active)
    torch.cuda.synchronize()
    assert torch.equal(got, TU.apply_moves_plain(*t, active))
    assert torch.equal(got[~active], t[0][~active])
    assert torch.equal(got[active], TU.apply_moves_cuda(*t)[active])
    assert not torch.equal(got[active], t[0][active])


@pytest.mark.parametrize("ploidy,seed", CASES + [(5, 60), (6, 61)])
def test_climb_on_the_card_matches_the_cpu(dev, ploidy, seed):
    alleles, weights, assign, nreads, eps = _batch(ploidy, seed, G=6)
    want = TU.upem_optimize_device(alleles, weights, assign, nreads, eps,
                                   ploidy, max_alleles=2, device="cpu")
    _build.LAUNCHES.clear()
    got = TU.upem_optimize_device(alleles, weights, assign, nreads, eps,
                                  ploidy, max_alleles=2, device=dev)
    for a, b in zip(want, got):
        assert torch.equal(a, b.cpu())
    # The whole climb is one launch of K6's climb kernel; K4 runs inside.
    assert _build.LAUNCHES["upem_moves"] == 0
    assert _build.LAUNCHES["upem_eval"] == 0
    assert _build.LAUNCHES["upem_climb"] == 1


def _climb_kernel_vs_plain(dev, args, P, A, **route):
    """The climb kernel (route forced by `route`) against
    upem_climb_plain on the same card, bitwise."""
    t = [torch.as_tensor(x).to(dev) for x in args]
    _build.LAUNCHES.clear()
    got = TU.upem_climb_cuda(*t, P, A, **route)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"upem_climb": 1}
    want = TU.upem_climb_plain(*t, P, A)
    for name, a, b in zip(("best", "mec", "diff"), want, got):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    return got


@pytest.mark.parametrize("R,S,P,A,seed,nreads", CLIMB_CASES)
def test_climb_kernel_matches_plain(dev, R, S, P, A, seed, nreads):
    """The climb kernel as the main path launches it (its own plan)."""
    _climb_kernel_vs_plain(dev, climb_case(R, S, P, A, seed, nreads), P, A)


@pytest.mark.parametrize("G", [1, 8, 16, 17, 33, 66, 67, 115, 200])
def test_climb_cluster_width_follows_k1(dev, G):
    """The climb's cluster width is K1's (`beam.cluster_width`, which its C
    entry picks) wherever each CTA keeps 128 columns (S = 2048)."""
    sms, _limit = TU.card(dev)
    assert TU.climb_cluster_width(G, 2048, sms) == TB.cluster_width(G, dev)


@pytest.mark.parametrize("route", [
    {"cluster": 1, "shared": True}, {"cluster": 1, "shared": False},
    {"cluster": 2, "shared": True}, {"cluster": 4, "shared": False},
    {"cluster": 8, "shared": True}, {"cluster": 8, "shared": False}])
@pytest.mark.parametrize("case", [0, 2, 4, 6, 9])
def test_climb_kernel_routes_match_plain(dev, case, route):
    """Each route forced: one CTA or a cluster per instance (S not a
    multiple of 8 or of the cluster width), the instance region in shared
    memory or in a device scratch."""
    R, S, P, A, seed, nreads = CLIMB_CASES[case]
    _climb_kernel_vs_plain(dev, climb_case(R, S, P, A, seed, nreads), P, A,
                           **route)


@pytest.mark.parametrize("G,R,S,P,A", [(8, 320, 2048, 5, 2),
                                       (40, 192, 1024, 5, 2),
                                       (70, 256, 2048, 3, 4),
                                       (6, 256, 2048, 6, 4)])
def test_climb_kernel_at_dispatch_shapes_matches_plain(dev, G, R, S, P, A):
    """Dispatch-sized batches: the kernel sweep's (clusters of 8), a
    config4-like bucket (clusters of 2 at G = 40), four alleles at
    S = 2048 and P = 3 (no cluster at G = 70; 212 KB of shared memory),
    and P = 6 with four alleles (clusters of 8 bring it into shared
    memory)."""
    args = climb_case(R, S, P, A, G + P, [R - g % 5 for g in range(G)],
                      err=0.02)
    sms, limit = TU.card(dev)
    C, _lay, shared, _arr = TU.climb_plan(G, R, S, P, A, sms, limit)
    _climb_kernel_vs_plain(dev, args, P, A)
    if G <= 8:
        assert C == 8 and shared


@pytest.mark.parametrize("route", [{"cluster": 1}, {"cluster": 4},
                                   {"cluster": 2, "shared": False}])
@pytest.mark.parametrize("S", [256, 200, 61])
def test_climb_kernel_reads_with_gaps_match_plain(dev, S, route):
    """Reads with uncovered cells inside their spans and second segments
    (each read's span bounds the cells the kernel loads), on the 16-byte
    (S = 256), 4-byte (S = 200) and scalar (S = 61) load routes."""
    args = climb_case(96, S, 3, 2, S, [96, 90, 50, 7], holes=0.1)
    _climb_kernel_vs_plain(dev, args, 3, 2, **route)


def test_climb_kernel_launch_makes_no_host_wait(dev):
    """upem_optimize_device on a card: one launch, no K4 launch, and no
    host wait (sync debug mode "error")."""
    R, S, P, A, seed, nreads = CLIMB_CASES[0]
    t = [torch.as_tensor(x).to(dev) for x in climb_case(R, S, P, A, seed,
                                                          nreads)]
    TU.upem_optimize_device(*t, P, A, device=dev)     # plan and build
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = TU.upem_optimize_device(*t, P, A, device=dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert dict(_build.LAUNCHES) == {"upem_climb": 1}
    want = TU.upem_climb_plain(*t, P, A)
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def test_climb_wrapper_checks_inputs(dev):
    args = [torch.as_tensor(x).to(dev) for x in climb_case(
        16, 40, 2, 2, 1, [16, 9])]
    al, wt, asg, nr, ep = args
    _build.LAUNCHES.clear()
    for bad in ((al.long(), wt, asg, nr, ep), (al, wt.double(), asg, nr, ep),
                (al, wt, asg.long(), nr, ep), (al, wt, asg, nr.long(), ep),
                (al, wt, asg, nr, ep[:1]), (al, wt, asg.cpu(), nr, ep)):
        with pytest.raises(ValueError):
            TU.upem_climb_cuda(*bad, 2, 2)
    with pytest.raises(ValueError):
        TU.upem_climb_cuda(*args, 2, 5)
    assert _build.LAUNCHES["upem_climb"] == 0
    with pytest.raises(RuntimeError):      # refused, never run
        TU.upem_climb_cuda(*args, 2, 2, cluster=16)
    assert _build.LAUNCHES["upem_climb"] == 0


def _deep_blocks():
    """Blocks of up to five strains in config4's most common dispatch
    bucket (R = 192, S = 1024; it reaches levels 2-5 there), rows cut to
    each block's live reads."""
    from floria_tpu_torch.entry import _synth_blocks

    return [(j, dataclasses.replace(
        bt, alleles=bt.alleles[:bt.num_reads],
        weights=bt.weights[:bt.num_reads], quals=bt.quals[:bt.num_reads],
        frag_ids=bt.frag_ids[:bt.num_reads]))
        for j, bt in _synth_blocks(10, 192, 1024, 5, seed=8)]


@pytest.mark.parametrize("which", ["workload", "deep"])
def test_sweep_level_launch_makes_no_host_wait(dev, which, monkeypatch):
    """One sweep level enqueued (`_sweep_launch`) under sync debug mode
    "error": no call may wait on the card. `_sweep_pull` then waits once
    (one event) and gives the CPU route's results."""
    from floria_tpu_torch.options import Options

    blocks = workload_blocks() if which == "workload" else _deep_blocks()
    opts = Options(epsilon=0.02, max_ploidy=6)
    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    caches = {card: TL.BlockDeviceCache(blocks, device=card)}
    cpu_caches = {cpu: TL.BlockDeviceCache(blocks, device=cpu)}
    waits = []
    sync = torch.cuda.Event.synchronize
    monkeypatch.setattr(torch.cuda.Event, "synchronize",
                        lambda ev: (waits.append(ev), sync(ev))[1])
    levels = [(1, 2), 3] if which == "workload" else [3, 5]
    for level in levels:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = TL._sweep_launch(blocks, opts, [card], caches, [level])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        n = len(waits)
        refined, stats = TL._sweep_pull(pending)
        assert len(waits) == n + 1
        if which == "deep":
            want = TL._sweep_pull(TL._sweep_launch(blocks, opts, [cpu],
                                                   cpu_caches, [level]))
            assert stats == want[1]
            for k, v in want[0].items():
                assert np.array_equal(refined[k], v)


def _beam_sharded_vs_unsharded(mesh, G=70):
    """K1 through beam_search_sharded over `mesh` against one unsharded
    K1 call on the first card: bitwise, one launch per shard."""
    nparts = [2 + g % 4 for g in range(G)]
    args = _random_case(G, 48, 256, 5, 31, nparts)
    ref, ref_asg = TB.beam_search_traceback(*args, 5, 10, max_alleles=2,
                                            device=mesh[0])
    _build.LAUNCHES.clear()
    got, asg = TM.beam_search_sharded(mesh, *args, 5, 10, max_alleles=2)
    assert _build.LAUNCHES["beam_scan"] == len(mesh)
    for name, a, b in zip(ref._fields, ref, got):
        assert a.cpu().numpy().dtype == b.dtype, name
        assert np.array_equal(a.cpu().numpy(), b), name
    assert np.array_equal(ref_asg.cpu().numpy(), asg)


def _sweep_sharded_vs_unsharded(mesh):
    from floria_tpu_torch.entry import _synth_blocks
    from floria_tpu_torch.options import Options
    from test_torch_sweep import _assert_sweeps_equal

    # Rows cut to each block's live reads, as pack_block lays them out.
    blocks = [(j, dataclasses.replace(
        bt, alleles=bt.alleles[:bt.num_reads],
        weights=bt.weights[:bt.num_reads], quals=bt.quals[:bt.num_reads],
        frag_ids=bt.frag_ids[:bt.num_reads]))
        for j, bt in _synth_blocks(12, 96, 512, 4, seed=3)]
    opts = Options(epsilon=0.02, max_ploidy=4)
    want = TL.adaptive_sweep(blocks, opts, device=mesh[0])
    _build.LAUNCHES.clear()
    got = TL.adaptive_sweep(blocks, opts, device=mesh)
    assert _build.LAUNCHES["beam_scan"] >= len(mesh)
    # Each shard's climbs are K6 launches; K4 runs inside them.
    assert _build.LAUNCHES["upem_climb"] >= len(mesh)
    assert _build.LAUNCHES["upem_moves"] == 0
    _assert_sweeps_equal(want, got)


def test_sharded_beam_on_one_card_matches_unsharded(dev):
    """Two shards on one card (clusters of two CTAs each, against one
    CTA per instance unsharded)."""
    _beam_sharded_vs_unsharded([torch.device("cuda", 0)] * 2)


def test_sharded_sweep_on_one_card_matches_unsharded(dev):
    _sweep_sharded_vs_unsharded([torch.device("cuda", 0)] * 2)


def test_shards_on_two_cards_match_one_card(dev):
    """Guards the wrappers' device switch: K1 and K4 set kernel
    attributes and K1 reads the SM count of the current device, so a
    shard on cuda:1 must make cuda:1 current. Needs two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    mesh = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert TB.cluster_width(8, mesh[1]) == TB.cluster_width(8, mesh[0])
    _beam_sharded_vs_unsharded(mesh)
    _sweep_sharded_vs_unsharded(mesh)
    entry.dryrun_multichip(2, device=mesh)


@pytest.mark.parametrize("name", SMALL)
def test_cuda_cli_matches_jax_cpu(name, dev, tmp_path):
    """Tie order and prune decisions on the card against the reference
    directly: the port's CLI on cuda:0 and floria_tpu.pipeline.run on
    JAX's CPU backend, same inputs and -o, every output file but
    cmd.log byte-equal (a difference names the file and its first
    differing line); the JAX bytes also equal the golden record's."""
    _build.LAUNCHES.clear()
    run_both(name, tmp_path, device="cuda:0", port_cli=True)
    assert _build.LAUNCHES["beam_scan"] > 0


def _recorded_sweep(case, tmp_path):
    """The port's CLI on cuda:0 with its sweeps, beam dispatches, climbs
    and NW partitions recorded (test_torch_decisions_a.record_run): on a
    config of the golden record (its outputs held to the JAX CLI's
    hashes), on bench.py's `ecoli2`, or on config #5's 500-contig
    community `multi500` in one process."""
    import chip_smoke
    from floria_tpu_torch.sim.simulate import (SimConfig, simulate,
                                               simulate_multi)

    if case in chip_smoke.load_north_star()["configs"]:
        return record_config(case, str(tmp_path), device="cuda:0")
    sim_dir, out_dir = str(tmp_path / case), str(tmp_path / "out")
    if case == "ecoli2":
        simulate(SimConfig(**chip_smoke.ECOLI2), sim_dir)
    else:
        simulate_multi(chip_smoke.multi_configs(chip_smoke.MULTI_CONTIGS),
                       sim_dir)
    return record_run(sim_dir, out_dir, device="cuda:0")


@pytest.mark.parametrize("case", SMALL + ["config4", "ecoli2", "multi500"])
def test_k1_decisions_match_jax_beam(case, dev, tmp_path):
    """The port's decisions on the card against the JAX package on JAX's
    CPU backend, on the main path's own recorded calls
    (test_torch_decisions_a's holds): every sweep block by block against
    `adaptive_sweep` (chosen ploidy, assignment, MEC and expected-error
    vectors), every K1 beam dispatch instance by instance against
    `_beam_search_batch_mixed_jit` + `traceback_batch` (parent and part
    records, scores, live flags, final assignment), every K6 climb
    against `_upem_optimize_device_jit` (best, mec, diff) and every
    fused level 2's ploidy-1 MEC against `_eval_mec`. The 12 small
    configs, config4 (sweep levels 2-5), ecoli2 (its six dispatches, and
    its largest, G=115, R=256, S=2048, also on the same blocks at P=3
    through K1 again) and multi500 (config #5, 500 contigs, one
    process). Nothing may differ."""
    rec = _recorded_sweep(case, tmp_path)
    levels = {P for _inp, P, *_r in rec.beams}
    if case in ("long3", "config4"):
        assert levels >= ({2, 3, 4, 5} if case == "config4" else {2, 3})
    if case == "ecoli2":
        (al, wt, nr, ep, npt), P, W, kw, _out = max(
            rec.beams, key=lambda d: d[0][0].shape[0])
        assert tuple(al.shape) == (115, 256, 2048) and P == 2
        npt3 = torch.full_like(npt, 3)
        again = TB.beam_search_traceback(
            al, wt, nr, ep, npt3, 3, W, max_alleles=kw["max_alleles"],
            window=kw["window"], device=dev)
        rec.beams.append(((al, wt, nr, ep, npt3), 3, W, kw, again))
    counts = hold_counts(rec)
    print("DECISIONS_VS_JAX " + json.dumps({
        "case": case, "sweeps": len(rec.sweeps),
        "beam_dispatches": len(rec.beams),
        "climbs": len(rec.climbs.climbs), "levels": sorted(levels),
        "largest_G_R_S": max(tuple(d[0][0].shape) for d in rec.beams),
        **{f"{h}_compared": n for h, (n, _f) in counts.items()},
        **{f"{h}_differing": len(f) for h, (_n, f) in counts.items()},
        "first_differing": {h: f[:10] for h, (_n, f) in counts.items()
                            if f},
        "nvidia_smi": nvidia_smi_line()}))
    for h, (n, flips) in counts.items():
        assert n > 0 and flips == [], (case, h, flips[:20])


def test_k5_decisions_match_jax_nw(dev, tmp_path):
    """K5 at ecoli2's one device partition (643,124 unique jobs), as the
    main path launched it, against the JAX NW on the same packed inputs
    (test_torch_decisions_a.jax_nw_flips): each job's best allele
    against `_nw_best_chunked` and, from a second K5 launch that also
    writes them, each allele's score against `_nw_scores`."""
    import chip_smoke
    from floria_tpu_torch.sim.simulate import SimConfig, simulate

    sim_dir = str(tmp_path / "ecoli2")
    simulate(SimConfig(**chip_smoke.ECOLI2), sim_dir)
    with chip_smoke.DispatchRecorder() as rec:
        chip_smoke.run_cli(sim_dir, str(tmp_path / "out"), device="cuda:0")
    assert len(rec.nw) == 1
    args, best = rec.nw[0]
    assert args[0].shape[0] == 643_124
    scores = torch.empty((args[0].shape[0], args[5]), dtype=torch.int32,
                         device=args[0].device)
    again = TR.nw_best_cuda(*args, scores=scores)
    assert torch.equal(again, best)
    n, flips = jax_nw_flips(args, best, scores)
    print("DECISIONS_VS_JAX " + json.dumps({
        "case": "ecoli2 NW partition", "jobs_compared": n,
        "jobs_differing": len(flips), "first_differing": flips[:10],
        "alleles": args[5], "nvidia_smi": nvidia_smi_line()}))
    assert n == 643_124 and flips == []
