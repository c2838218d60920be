"""The UPEM hill-climb as the port runs it on a card (K6 init, a fixed
NUM_ITER_OPTIMIZE rounds of the masked move function and K6 step, K6
mec), here through the plain versions on the CPU, against the JAX
reference, bitwise: `upem_eval_plain`'s three modes against
`_eval_diff_score` / `_eval_mec` and one iteration of the reference
climb's while_loop body; the fixed-round loop against
`upem_optimize_device` (including instances that stop in different
rounds); one instance alone against the batch; the masked move function;
the sweep's host-side window check against K1's device check; and the
dispatch window's decision against the reference's policy on every
member, with the blocks it reads per call (`window_blocks`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floria_tpu.kernels import upem_batch as U
from floria_tpu_torch import constants, timing
from floria_tpu_torch.kernels import beam as TB
from floria_tpu_torch.kernels import upem_batch as TU
from floria_tpu_torch.kernels.blocktensor import BlockTensor, round_up
from test_torch_upem import CASES, _batch

# One intra-op thread: the suite runs several pytest workers on one
# host, and oversubscribed OpenMP threads slow every worker down.
torch.set_num_threads(1)


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _jax_eval(alleles, weights, assign, eps, P):
    with jax.enable_x64():
        d, s = U._eval_diff_score(jnp.asarray(alleles), jnp.asarray(weights),
                                  jnp.asarray(assign), jnp.asarray(eps), P, 2)
        m = U._eval_mec(jnp.asarray(alleles), jnp.asarray(assign),
                        jnp.asarray(eps), P, 2)
        return np.asarray(d), np.asarray(s), np.asarray(m)


def _jax_step(alleles, weights, proposal, eps, P, best, best_score, diff,
              active):
    """The reference climb's while_loop body (upem_batch.py:343-354)
    after its move function, on a given proposal."""
    changed = (proposal != best).any(axis=1)
    active = active & changed
    new_diff, new_score, _m = _jax_eval(alleles, weights, proposal, eps, P)
    improved = active & (new_score > best_score)
    return (np.where(improved[:, None], proposal, best),
            np.where(improved, new_score, best_score),
            np.where(improved[:, None, None], new_diff, diff), improved)


def _assert_same(want, got):
    for a, b in zip(want, got):
        b = b.numpy()
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("ploidy,seed", CASES)
def test_upem_eval_plain_init_and_mec_match_jax(ploidy, seed):
    alleles, weights, assign, _nr, eps = _batch(ploidy, seed)
    d, s, m = _jax_eval(alleles, weights, assign, eps, ploidy)
    args = _t(alleles, weights, assign, eps)
    diff, score, active = TU.upem_eval_plain("init", *args, ploidy, 2)
    _assert_same((d, s), (diff, score))
    assert active.dtype == torch.bool and bool(active.all())
    _assert_same((m,), (TU.upem_eval_plain("mec", *args, ploidy, 2),))


@pytest.mark.parametrize("ploidy,seed", [(2, 3), (3, 11)])
def test_upem_eval_plain_step_matches_jax_loop_body(ploidy, seed):
    """One step on four instances: a proposal that scores higher
    (accepted), one that scores lower (rejected), one equal to `best`
    (unchanged) and an inactive instance; padding rows assigned -1."""
    alleles, weights, assign, nreads, eps = _batch(ploidy, seed, G=4)
    refined = np.asarray(U.upem_optimize_device(
        alleles, weights, assign, nreads, eps, ploidy, max_alleles=2)[0])
    best, proposal = assign.copy(), assign.copy()
    best[0], proposal[0] = assign[0], refined[0]    # up from random
    best[1], proposal[1] = refined[1], assign[1]    # down to random
    best[2], proposal[2] = refined[2], refined[2]   # unchanged
    best[3], proposal[3] = assign[3], refined[3]    # inactive
    assert (best[:, -1] == -1).all() and (proposal[:, -1] == -1).all()
    d, s, _m = _jax_eval(alleles, weights, best, eps, ploidy)
    active = np.array([True, True, True, False])
    want = _jax_step(alleles, weights, proposal, eps, ploidy, best, s, d,
                     active)
    np.testing.assert_array_equal(want[3], [True, False, False, False])
    assert not np.array_equal(want[0][0], best[0])
    np.testing.assert_array_equal(want[0][1:], best[1:])

    tb, tp, ta, tw, te = _t(best, proposal, alleles, weights, eps)
    state = (tb, torch.from_numpy(s.copy()), torch.from_numpy(d.copy()),
             torch.from_numpy(active.copy()))
    got = TU.upem_eval_plain("step", ta, tw, tp, te, ploidy, 2, state)
    assert got is state
    _assert_same(want, state)


def _plain_rounds(alleles, weights, assign, nreads, eps, P):
    """The fixed-round climb step by step with the plain versions:
    (best, mec, diff, the round each instance went inactive in, or -1)."""
    ta, tw, tn, te = _t(alleles, weights, nreads, eps)
    best = torch.from_numpy(assign.copy())
    diff, score, active = TU.upem_eval_plain("init", ta, tw, best, te, P, 2)
    state = (best, score, diff, active)
    stop = np.full(len(assign), -1)
    for k in range(constants.NUM_ITER_OPTIMIZE):
        proposal = TU.apply_moves_plain(best, diff, tn, active)
        was = active.numpy().copy()
        TU.upem_eval_plain("step", ta, tw, proposal, te, P, 2, state)
        stop[was & ~active.numpy()] = k
    mec = TU.upem_eval_plain("mec", ta, tw, best, te, P, 2)
    return best, mec, diff, stop


@pytest.mark.parametrize("ploidy,seed", CASES)
def test_fixed_round_climb_matches_jax(ploidy, seed):
    alleles, weights, assign, nreads, eps = _batch(ploidy, seed)
    want = U.upem_optimize_device(alleles, weights, assign, nreads, eps,
                                  ploidy, max_alleles=2)
    ta, tw, tn, te = _t(alleles, weights, nreads, eps)
    best, mec, diff = TU._climb(ta, tw, torch.from_numpy(assign.copy()), tn,
                                te, ploidy, 2, early_exit=False)
    _assert_same(want, (best, mec, diff * TU.INV_WEIGHT_SCALE))
    got = TU.upem_optimize_device(alleles, weights, assign, nreads, eps,
                                  ploidy, max_alleles=2, device="cpu")
    _assert_same(want, got)


def test_instances_that_stop_in_different_rounds_match_jax():
    alleles, weights, assign, nreads, eps = _batch(3, 50, G=6)
    best, mec, diff, stop = _plain_rounds(alleles, weights, assign, nreads,
                                          eps, 3)
    assert len(set(stop.tolist())) >= 3, stop
    want = U.upem_optimize_device(alleles, weights, assign, nreads, eps, 3,
                                  max_alleles=2)
    _assert_same(want, (best, mec, diff * TU.INV_WEIGHT_SCALE))
    ta, tw, tn, te = _t(alleles, weights, nreads, eps)
    fixed = TU._climb(ta, tw, torch.from_numpy(assign.copy()), tn, te, 3, 2,
                      early_exit=False)
    for a, b in zip((best, mec, diff), fixed):
        assert torch.equal(a, b)


@pytest.mark.parametrize("ploidy,seed", [(2, 50), (3, 50)])
def test_each_instance_alone_matches_the_batch(ploidy, seed):
    alleles, weights, assign, nreads, eps = _batch(ploidy, seed, G=6)
    batch = TU.upem_optimize_device(alleles, weights, assign, nreads, eps,
                                    ploidy, max_alleles=2, device="cpu")
    for g in range(len(assign)):
        one = TU.upem_optimize_device(
            alleles[g:g + 1], weights[g:g + 1], assign[g:g + 1],
            nreads[g:g + 1], eps[g:g + 1], ploidy, max_alleles=2,
            device="cpu")
        for a, b in zip(batch, one):
            assert torch.equal(a[g:g + 1], b)


@pytest.mark.parametrize("P,seed", [(2, 1), (3, 2), (5, 3)])
def test_masked_move_function_matches_jax(P, seed):
    """K4's plain version with an `active` mask: active instances move as
    the reference's `_apply_moves_single`, inactive ones propose their
    assignment unchanged."""
    from test_torch_upem import _jax_moves, moves_case

    assign, diff, nreads = moves_case(6, 48, P, seed)
    active = np.array([True, False, True, True, False, True])
    want = np.array(_jax_moves(assign, diff, nreads))
    want[~active] = assign[~active]
    got = TU.apply_moves_plain(*_t(assign, diff, nreads),
                               torch.from_numpy(active))
    np.testing.assert_array_equal(want, got.numpy())
    assert (want[active] != assign[active]).any()
    assert torch.equal(TU.apply_moves(*_t(assign, diff, nreads),
                                      torch.from_numpy(active)), got)


def _window_blocks(rng, G, S, s_block, shuffle, holes=True):
    """G blocks of rows of random spans inside s_block <= S columns,
    sorted by start unless `shuffle`, with `holes` some rows covering
    nothing (a real block's reads all cover a column), as ([R, s_block]
    alleles, num_reads) each."""
    out = []
    for _g in range(G):
        R = int(rng.integers(4, 40))
        al = np.full((R, s_block), -1, np.int8)
        starts = np.sort(rng.integers(0, s_block, R))
        if shuffle:
            rng.shuffle(starts)
        for r, s0 in enumerate(starts):
            if holes and rng.random() < 0.1:
                continue
            span = int(rng.integers(1, 200))
            al[r, s0:min(s_block, s0 + span)] = rng.integers(0, 2)
        out.append((al, int(rng.integers(1, R + 1))))
    return out


@pytest.mark.parametrize("seed", range(8))
def test_host_window_check_raises_where_device_check_raises(seed):
    """`check_windows_host` per block (the sweep's check, from the
    blocks' rows) against `_check_windows` on the padded dispatch tensor,
    dispatch by dispatch and block by block, over windows that hold every
    read and windows that cut some."""
    rng = np.random.default_rng(seed)
    S = 1024
    raised = {True: 0, False: 0}
    for trial in range(12):
        s_block = int(rng.choice([S, S - 200, 600]))
        blocks = _window_blocks(rng, 3, S, s_block, shuffle=trial % 3 == 0)
        window = int(rng.choice([128, 256, 384, 512]))
        padded = np.full((len(blocks), 40, S), -1, np.int8)
        nreads = np.zeros(len(blocks), np.int32)
        for g, (al, nr) in enumerate(blocks):
            padded[g, :al.shape[0], :s_block] = al
            nreads[g] = nr
        for g in range(len(blocks) + 1):
            # Each block alone, then the whole dispatch.
            sel = slice(g, g + 1) if g < len(blocks) else slice(None)
            try:
                TB._check_windows(*_t(padded[sel], nreads[sel]), window)
                want = False
            except ValueError:
                want = True
            try:
                for al, nr in blocks[sel]:
                    TB.check_windows_host(*TB.read_columns(al, nr), S,
                                          window)
                got = False
            except ValueError:
                got = True
            assert got == want, (trial, g, window)
            raised[want] += 1
    assert raised[True] > 0 and raised[False] > 0


@pytest.mark.parametrize("s_pad", [512, 2048])
def test_dispatch_window_is_the_reference_policy(s_pad):
    """The sweep's window (span from `read_columns`) equals the
    reference's policy on BlockTensor.max_read_span."""
    from floria_tpu_torch.phase.local import _dispatch_window

    rng = np.random.default_rng(s_pad)
    blocks = [(g, BlockTensor(frag_ids=np.arange(nr), lo=1, num_sites=512,
                              num_reads=nr, alleles=al, weights=al * 0.0,
                              snp_range=(1, 512)))
              for g, (al, nr) in enumerate(
                  _window_blocks(rng, 12, 512, 512, shuffle=False,
                                 holes=False))]
    windows = set()
    for k in range(0, 12, 3):
        chunk = blocks[k:k + 3]
        want = round_up(max(bt.max_read_span() for _j, bt in chunk) + 128,
                        256)
        if want * 4 > s_pad:
            want = 0
        assert _dispatch_window(chunk, s_pad, {}) == want
        windows.add(want)
    assert windows != {0} or s_pad == 512


def _span_block(rng, S, max_span, *, long_span=0, reverse=False):
    """A block of S columns whose reads span 1..max_span columns, sorted
    by start unless `reverse` (then in descending order), with one read
    of `long_span` columns when given; some rows past num_reads."""
    R = int(rng.integers(4, 24))
    al = np.full((R, S), -1, np.int8)
    starts = np.sort(rng.integers(0, S - max_span, R))
    starts[-1] = max(starts[-1], 128)
    if reverse:
        starts = starts[::-1]
    for r, s0 in enumerate(starts):
        al[r, s0:s0 + int(rng.integers(1, max_span + 1))] = rng.integers(0, 2)
    if long_span:
        r = int(rng.integers(0, R))
        al[r] = -1
        s0 = int(rng.integers(0, S - long_span + 1))
        al[r, s0:s0 + long_span] = 1
    nr = R if long_span or reverse else int(rng.integers(R // 2, R + 1))
    return BlockTensor(frag_ids=np.arange(nr), lo=1, num_sites=S,
                       num_reads=nr, alleles=al, weights=al * 0.0,
                       snp_range=(1, S))


def _full_scan_window(chunk, s_pad):
    """The reference's window policy over every member of the chunk, read
    in full: round_up(longest max_read_span + 128, 256), 0 below a 4x
    shrink of s_pad, and each block's window checked on the host."""
    window = round_up(max(bt.max_read_span() for _j, bt in chunk) + 128,
                      256)
    if window * 4 > s_pad:
        return 0
    for _j, bt in chunk:
        TB.check_windows_host(*TB.read_columns(bt.alleles, bt.num_reads),
                              s_pad, window)
    return window


def _window_decision(fn):
    """(fn()'s result or the ValueError it raised, the `window_blocks`
    counts of the `dispatch.window` spans it recorded)."""
    last = max((r.id for r in timing.records()), default=0)
    try:
        got = fn()
    except ValueError as exc:
        got = ValueError(str(exc))
    counts = [r.counts["window_blocks"] for r in timing.records()
              if r.id > last and r.name == "dispatch.window"]
    return got, counts


def _same_decision(a, b):
    if isinstance(a, ValueError) or isinstance(b, ValueError):
        return type(a) is type(b) and str(a) == str(b)
    return a == b


# What each chunk of the decision's cases holds, and what it must decide
# at s_pad >= 1,024 ("window", 0 or a raise).
WINDOW_CASES = {
    "short": "window",          # every read inside the window's limit
    "long": 0,                  # the first block rules a window out
    "last_rules": 0,            # only the last block's read rules it out
    "duplicates": "window",     # one block at several ploidies
    "unsorted": "raises",       # reads in descending order: the check
}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
@pytest.mark.parametrize("s_pad", [512, 1024, 1536, 2048])
def test_dispatch_window_equals_the_full_scan(s_pad, case):
    """`_dispatch_window` (the blocks read once through the call's table,
    stopping at the first block that rules a window out) returns the
    window, or raises, as the reference's policy over every member does;
    it reads each distinct block at most once, and none again from a
    table that holds them."""
    from floria_tpu_torch.phase.local import _dispatch_window

    limit = s_pad // 1024 * 256 - 128       # the longest span a window
    short = max(limit, 100)                 # allows (at 512: none)
    rng = np.random.default_rng(s_pad * 7 + len(case))
    for _trial in range(4):
        S = s_pad - int(rng.integers(0, 200))
        blocks = [(j, _span_block(rng, S, short,
                                  reverse=case == "unsorted"))
                  for j in range(5)]
        if case == "long":
            blocks[0] = (0, _span_block(rng, S, short, long_span=max(
                limit + 1 + int(rng.integers(0, 64)), 300)))
        if case == "last_rules":
            blocks[-1] = (4, _span_block(rng, S, short, long_span=max(
                limit + 1, 300)))
        chunk = (blocks + blocks[1:4] + blocks[:2]
                 if case == "duplicates" else blocks)
        want, _ = _window_decision(lambda: _full_scan_window(chunk, s_pad))
        spans = {}
        got, (n,) = _window_decision(
            lambda: _dispatch_window(chunk, s_pad, spans))
        assert _same_decision(got, want), (case, s_pad, got, want)
        assert n == len(spans)
        again, (n,) = _window_decision(
            lambda: _dispatch_window(chunk, s_pad, spans))
        assert _same_decision(again, want) and n == 0
        expect = WINDOW_CASES[case] if s_pad >= 1024 else 0
        if expect == "raises":
            assert isinstance(want, ValueError)
        else:
            assert (want > 0) == (expect == "window")
        assert len(spans) == (0 if s_pad < 1024 else
                              1 if case == "long" else len(blocks))


def _api_blocks(n, span, seed, S=1000, R=12):
    """n blocks of R reads of `span` columns over S columns (the s_pad
    1,024 bucket) from two strains, sorted by start, phred 20: a window
    applies at span <= 128 and is ruled out above."""
    from floria_tpu_torch.frag import phred_weight

    rng = np.random.default_rng(seed)
    out = []
    for j in range(n):
        strains = rng.integers(0, 2, (2, S))
        al = np.full((R, S), -1, np.int8)
        quals = np.zeros((R, S), np.uint8)
        for r, s0 in enumerate(np.sort(rng.integers(0, S - span, R))):
            hap = strains[rng.integers(0, 2), s0:s0 + span].copy()
            err = rng.random(span) < 0.02
            hap[err] = 1 - hap[err]
            al[r, s0:s0 + span] = hap
            quals[r, s0:s0 + span] = 20
        out.append((j, BlockTensor(
            frag_ids=np.arange(R, dtype=np.int64), lo=1, num_sites=S,
            num_reads=R, alleles=al, weights=phred_weight(quals),
            snp_range=(1, S), quals=quals)))
    return out


@pytest.fixture
def spied_windows(monkeypatch):
    """The `window` of every beam dispatch launched; dispatches of at
    most three instances at R 16, S 1,024."""
    from floria_tpu_torch.phase import local as TL

    monkeypatch.setenv("FLORIA_SWEEP_CAP_CELLS", str(3 * 16 * 1024))
    windows = []
    real = TL.beam_kernel.beam_search_traceback

    def spy(*args, **kw):
        windows.append(kw["window"])
        return real(*args, **kw)

    monkeypatch.setattr(TL.beam_kernel, "beam_search_traceback", spy)
    return windows


@pytest.mark.parametrize("span", [100, 300])
def test_phase_instances_reads_each_block_once_a_call(span, spied_windows):
    """At ploidies 2..5, the call's `window_blocks` are the distinct
    blocks where windows apply (each block once, not once per ploidy),
    at most one a dispatch where the first block rules a window out; a
    second call on the same blocks reads and answers as the first."""
    from floria_tpu_torch.options import Options
    from floria_tpu_torch.phase import local as TL

    blocks = _api_blocks(4, span, seed=span)
    opts = Options(epsilon=0.02, max_ploidy=5)
    calls = [_window_decision(lambda: TL.phase_instances(
        blocks, opts, [2, 3, 4, 5], device="cpu")) for _ in range(2)]
    (first, counts), (second, again) = calls
    assert counts == again and len(counts) == len(spied_windows) // 2 > 4
    if span <= 128:
        assert set(spied_windows) == {256}
        assert sum(counts) == len(blocks)
    else:
        assert set(spied_windows) == {0}
        assert sum(counts) <= len(counts) and max(counts) == 1
    assert first.keys() == second.keys()
    for key in first:
        np.testing.assert_array_equal(first[key], second[key])


@pytest.mark.parametrize("span", [100, 300])
def test_adaptive_sweep_reads_each_block_once(span, spied_windows):
    """Over all of a sweep's levels, each block's read columns are read
    at most once, and every block once where windows apply."""
    from floria_tpu_torch.options import Options
    from floria_tpu_torch.phase import local as TL

    blocks = _api_blocks(4, span, seed=span + 1)
    (chosen, _mec, _exp), counts = _window_decision(lambda: TL.adaptive_sweep(
        blocks, Options(epsilon=0.02, max_ploidy=4), device="cpu"))
    assert len(chosen) == len(blocks) and len(counts) > 1
    if span <= 128:
        assert set(spied_windows) == {256}
        assert sum(counts) == len(blocks)
    else:
        assert set(spied_windows) == {0}
        assert sum(counts) <= len(blocks)
