"""The port's CUDA kernels against their plain PyTorch versions on the
same card, bitwise: K1 (beam scan + traceback), K4 (UPEM move walk) and
K5 (realignment NW).

CUDA kernels have no CPU mode, so these tests need a card and skip
without one (decided inside the fixture). On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import dedup_case, nw_case, windowed_case
from floria_tpu_torch.kernels import _build
from floria_tpu_torch.kernels import beam as TB
from floria_tpu_torch.kernels import realign as TR
from floria_tpu_torch.kernels import upem_batch as TU
from test_beam_pallas import _make

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
    assert TB.cluster_width(G) > 1
    got, asg, ref, ref_asg = _kernel_vs_plain(
        dev, *_random_case(G, R, S, P, seed, nparts, A), P, W, A=A)
    _assert_same(got, asg, ref, ref_asg)


@pytest.mark.parametrize("G,A,width", [(70, 2, 1), (40, 4, 2), (20, 3, 4)])
def test_beam_kernel_cluster_widths_match_plain(dev, G, A, width):
    """G = 70 fills the card with one CTA per instance (no cluster);
    G = 40 and 20 take clusters of two and four. Mixed parts, padded
    reads, two to four alleles."""
    nparts = [2 + g % 4 for g in range(G)]
    assert TB.cluster_width(G) == width
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


@pytest.mark.parametrize("ploidy,seed", [(2, 0), (3, 1), (5, 2)])
def test_move_walk_kernel_matches_plain(dev, ploidy, seed):
    args = _random_case(6, 64, 128, ploidy, seed, [ploidy] * 6)
    al, wt, nr, ep, npt = TB._inputs(*args, dev)
    _res, asg = TB.beam_search_traceback(al, wt, nr, ep, npt, ploidy, 10,
                                         max_alleles=2, device=dev)
    assign = asg.to(torch.int32).contiguous()
    diff, _score = TU._eval_diff_score(al, wt, assign, ep, ploidy, 2)
    sizes0, order, n_valid = TU._move_candidates(assign, diff, nr)
    got = TU.apply_moves_cuda(assign, order, n_valid, sizes0)
    want = TU.apply_moves_plain(assign, order, n_valid, sizes0)
    assert torch.equal(got, want)


def test_wrappers_count_launches_and_check_inputs(dev):
    args = _random_case(2, 30, 32, 2, 1, (2, 2))
    _build.LAUNCHES.clear()
    TB.beam_search_traceback(*args, 2, 10, max_alleles=2, device=dev)
    assert _build.LAUNCHES["beam_scan"] == 1
    assign = torch.zeros((2, 30), dtype=torch.int32, device=dev)
    order = torch.zeros((2, 60), dtype=torch.int64, device=dev)
    n_valid = torch.zeros(2, dtype=torch.int64, device=dev)
    sizes0 = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        TU.apply_moves_cuda(assign, order.to(torch.int32), n_valid, sizes0)
    assert _build.LAUNCHES["upem_moves"] == 0
    TU.apply_moves_cuda(assign, order, n_valid, sizes0)
    assert _build.LAUNCHES["upem_moves"] == 1


@pytest.mark.parametrize("n,A,a_max,nal_set", [
    (1, 2, 2, 0), (1, 4, 4, 1), (1, 4, 4, None),
    (1000, 2, 2, None),      # 1000 = 7 blocks of 128 + 104
    (1000, 4, 4, None),      # nal 0..4
    (333, 4, 2, None),       # the biallelic partition of a 4-column table
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
