"""The PyTorch port's beam scan (plain path, CPU) against the JAX
reference (hist impl on JAX-CPU), bitwise: records, f64-quanta scores,
live flags and traceback assignments. The one stated exception is the
binomial-tail value itself, whose last bits depend on the backend's
`log`: it is compared at rtol=1e-12, decisions bitwise."""

import jax
import numpy as np
import pytest
import torch

import oracle
from floria_tpu.frag import Frag
from floria_tpu.kernels import beam as B
from floria_tpu.kernels.beam_pallas import beam_search_batch_pallas
from floria_tpu.kernels.blocktensor import pack_block
from floria_tpu.kernels.scores import binom_tail_jnp, log_sum_exp_jnp
from floria_tpu_torch import constants, state
from floria_tpu_torch.kernels import beam as TB
from floria_tpu_torch.kernels.scores import binom_tail, log_sum_exp
from test_beam_pallas import _make
from test_kernels import _mk_frag
from test_phred0_dedup import EPS as EPS_GRID
from test_phred0_dedup import _gen_qual0_frags
from test_windowed_beam import _long_block

# One intra-op thread: the suite runs several pytest workers on one
# host, and oversubscribed OpenMP threads slow every worker down.
torch.set_num_threads(1)
MASK = 0xFFFFFFFF

PALLAS_CASES = [
    (3, 40, 64, 3, 10, 0, (3, 2, 3)),
    (2, 30, 32, 2, 10, 1, (2, 2)),
    (2, 60, 128, 5, 10, 2, (5, 4)),
]


def _assert_result_equal(ref, got):
    for name, a, b in zip(ref._fields, ref, got):
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _both(alleles, weights, nreads, eps, nparts, P, W, A=2, window=0):
    ref = B.beam_search_batch_mixed(alleles, weights, nreads, eps, nparts,
                                    P, W, max_alleles=A, window=window)
    got, asg = TB.beam_search_traceback(alleles, weights, nreads, eps,
                                        nparts, P, W, max_alleles=A,
                                        window=window, device="cpu")
    return ref, got, asg


def _pallas_inputs(G, R, S, P, seed, nparts):
    alleles, weights = _make(G, R, S, P, seed)
    num_reads = np.array([R - (g % 7) for g in range(G)], np.int32)
    eps = np.full(G, 0.03, np.float32)
    return alleles, weights, num_reads, eps, np.asarray(nparts, np.int32)


@pytest.mark.parametrize("G,R,S,P,W,seed,nparts", PALLAS_CASES)
def test_beam_mixed_matches_jax(G, R, S, P, W, seed, nparts):
    args = _pallas_inputs(G, R, S, P, seed, nparts)
    ref, got, asg = _both(*args, P, W)
    _assert_result_equal(ref, got)
    tb = np.asarray(B.traceback_batch(tuple(ref)))
    assert tb.dtype == asg.numpy().dtype
    np.testing.assert_array_equal(tb, asg.numpy())
    np.testing.assert_array_equal(TB.traceback_batch(got).numpy(), tb)


@pytest.mark.parametrize("G,R,S,P,W,seed,nparts", PALLAS_CASES)
def test_beam_assignments_match_pallas_interpret(G, R, S, P, W, seed,
                                                 nparts):
    args = _pallas_inputs(G, R, S, P, seed, nparts)
    pal = beam_search_batch_pallas(*args, P, W, max_alleles=2,
                                   interpret=True)
    pa = np.asarray(B.traceback_batch(tuple(pal)))
    _res, asg = TB.beam_search_traceback(*args, P, W, max_alleles=2,
                                         device="cpu")
    for g in range(G):
        nr = args[2][g]
        np.testing.assert_array_equal(pa[g, :nr], asg.numpy()[g, :nr])


@pytest.mark.parametrize("window", [256, 384])
def test_beam_windowed_matches_jax_and_full(window):
    alleles, weights, nreads, eps = _long_block()
    nparts = np.full(alleles.shape[0], 2, np.int32)
    ref, got, _asg = _both(alleles, weights, nreads, eps, nparts, 2, 6,
                           window=window)
    _assert_result_equal(ref, got)
    full = TB.beam_search_batch_mixed(alleles, weights, nreads, eps,
                                      nparts, 2, 6, max_alleles=2,
                                      device="cpu")
    for name, a, b in zip(full._fields, full, got):
        assert torch.equal(a, b), name


def test_beam_dedup_case_matches_jax_and_oracle():
    """tests/test_kernels.py::test_beam_dedup_has_teeth's instance: one
    early short read, then reads far downstream."""
    rng = np.random.default_rng(0)
    ploidy = 3
    frags = [_mk_frag(0, {1: (0, 30), 2: (1, 30), 3: (0, 30)})]
    strains = rng.integers(0, 2, (ploidy, 60))
    for i in range(1, 40):
        k = rng.integers(0, ploidy)
        start = int(rng.integers(30, 45))
        sites = {}
        for snp in range(start, start + 12):
            allele = int(strains[k, snp - 1])
            if rng.random() < 0.03:
                allele = 1 - allele
            sites[snp] = (allele, int(rng.integers(10, 40)))
        frags.append(_mk_frag(i, sites))
    frags.sort(key=Frag.sort_key)
    for i, f in enumerate(frags):
        f.counter_id = i
    bt = pack_block(frags, (1, 60))
    args = (bt.alleles[None], bt.weights[None],
            np.array([bt.num_reads], np.int32),
            np.array([0.03], np.float32), np.array([ploidy], np.int32))
    ref, got, asg = _both(*args, ploidy, 10, A=4)
    _assert_result_equal(ref, got)
    want = oracle.beam_search([oracle.frag_to_read(f) for f in frags],
                              ploidy, 0.03, beam_width=10)
    assert list(asg.numpy()[0, :bt.num_reads]) == list(want)
    _nd, asg_nd = TB.beam_search_traceback(*args, ploidy, 10,
                                           max_alleles=4, dedup=False,
                                           device="cpu")
    assert list(asg_nd.numpy()[0, :bt.num_reads]) != list(want)


@pytest.mark.parametrize("seed,beam_width",
                         [(1, 1), (33, 1), (63, 2), (64, 3), (71, 1)])
def test_beam_phred0_dedup_matches_jax(seed, beam_width):
    frags = _gen_qual0_frags(seed)
    bt = pack_block(frags, (1, 8))
    args = (bt.alleles[None], bt.weights[None],
            np.array([bt.num_reads], np.int32),
            np.array([EPS_GRID], np.float32), np.array([2], np.int32))
    ref, got, asg = _both(*args, 2, beam_width, A=4)
    _assert_result_equal(ref, got)
    want = oracle.beam_search([oracle.frag_to_read(f) for f in frags], 2,
                              EPS_GRID, beam_width=beam_width,
                              zero_strip=True)
    assert list(asg.numpy()[0, :bt.num_reads]) == list(want)


def test_beam_long_block_matches_hist_f64_fallback():
    """R > 2048 takes the reference's combined-f64 hist fallback; the
    port's int64 state has no such bound."""
    G, R, S = 1, 2100, 48
    rng = np.random.default_rng(5)
    strains = rng.integers(0, 2, (2, S))
    alleles = np.full((G, R, S), -1, np.int8)
    weights = np.zeros((G, R, S), np.float32)
    starts = np.sort(rng.integers(0, S - 6, R))
    for r in range(R):
        s0 = starts[r]
        alleles[0, r, s0:s0 + 6] = strains[rng.integers(0, 2), s0:s0 + 6]
        weights[0, r, s0:s0 + 6] = 1.0 - 10.0 ** (
            rng.integers(10, 40, 6) / -10.0)
    ref, got, asg = _both(alleles, weights, np.array([R - 3], np.int32),
                          np.full(G, 0.02, np.float32),
                          np.array([2], np.int32), 2, 3)
    _assert_result_equal(ref, got)
    np.testing.assert_array_equal(np.asarray(B.traceback_batch(
        tuple(ref))), asg.numpy())


def test_prune_values_match_at_rtol_and_decisions_bitwise():
    rng = np.random.default_rng(11)
    n = np.floor(rng.uniform(0, 4000, (4000, 5)))
    k = np.floor(rng.uniform(0, 1, n.shape) * n)
    p = 0.02
    jb = np.asarray(binom_tail_jnp(n, k, p, 0.25))
    tb = binom_tail(torch.from_numpy(n), torch.from_numpy(k), p,
                    0.25).numpy()
    np.testing.assert_allclose(tb, jb, rtol=1e-12, atol=0)
    jl = np.asarray(log_sum_exp_jnp(jb, axis=-1))
    tl = log_sum_exp(torch.from_numpy(tb), dim=-1).numpy()
    np.testing.assert_allclose(tl, jl, rtol=1e-12, atol=0)
    cutoff = TB.CUTOFF
    np.testing.assert_array_equal((jb - jl[:, None]) > cutoff,
                                  (tb - tl[:, None]) > cutoff)


def _dedup_block():
    """test_beam_dedup_case_matches_jax_and_oracle's block, as arrays."""
    rng = np.random.default_rng(0)
    frags = [_mk_frag(0, {1: (0, 30), 2: (1, 30), 3: (0, 30)})]
    strains = rng.integers(0, 2, (3, 60))
    for i in range(1, 40):
        k = rng.integers(0, 3)
        start = int(rng.integers(30, 45))
        frags.append(_mk_frag(i, {
            snp: (int(strains[k, snp - 1]), int(rng.integers(10, 40)))
            for snp in range(start, start + 12)}))
    frags.sort(key=Frag.sort_key)
    bt = pack_block(frags, (1, 60))
    return (bt.alleles[None], bt.weights[None],
            np.array([bt.num_reads], np.int32),
            np.array([0.03], np.float32), np.array([3], np.int32))


def _long_reads_block():
    """R > 2048: test_beam_long_block_matches_hist_f64_fallback's shape."""
    G, R, S = 1, 2100, 48
    rng = np.random.default_rng(5)
    alleles = np.full((G, R, S), -1, np.int8)
    weights = np.zeros((G, R, S), np.float32)
    starts = np.sort(rng.integers(0, S - 6, R))
    for r in range(R):
        alleles[0, r, starts[r]:starts[r] + 6] = rng.integers(0, 2, 6)
        weights[0, r, starts[r]:starts[r] + 6] = 1.0 - 10.0 ** (
            rng.integers(10, 40, 6) / -10.0)
    return (alleles, weights, np.array([R - 3], np.int32),
            np.full(G, 0.02, np.float32), np.array([2], np.int32))


def _frontier_case(name):
    """(alleles, weights, nreads, eps, nparts, P, W, A, window)."""
    if name == "windowed":
        al, wt, nr, ep = _long_block()
        return al, wt, nr, ep, np.full(len(nr), 2, np.int32), 2, 6, 2, 256
    if name == "unwindowed":
        return (*_pallas_inputs(*PALLAS_CASES[2][:4], 2, (5, 4)), 5, 10, 2,
                0)
    if name == "dedup":
        return (*_dedup_block(), 3, 10, 4, 0)
    return (*_long_reads_block(), 2, 3, 2, 0)


def _chains(result, g, t, T1):
    """[outs, t + 1] part of reads 0..t along each slot's parent chain
    after step t, from the plain scan's records."""
    wp, wt, mp, mt = (x[g].numpy().astype(np.int64) for x in result[:4])

    def rec(r):
        return (wp[r], wt[r]) if r < T1 else (mp[r - T1], mt[r - T1])

    b = np.arange(len(rec(t)[0]))
    out = np.zeros((len(b), t + 1), np.int64)
    for r in range(t, -1, -1):
        par_r, prt_r = rec(r)
        out[:, r] = prt_r[b]
        b = par_r[b]
    return out


@pytest.mark.parametrize("case", ["windowed", "unwindowed", "dedup",
                                  "r2100"])
def test_frontier_bounds_hold_every_read_and_the_state(case):
    """K1's frontier bounds against a brute-force scan of the alleles:
    every column a read >= t covers lies at or above lo[t], every column
    a read <= t covers lies below hi[t], and in the plain scan's state
    after step t every count at or above hi[t] is zero. The same states
    check the identity K1's dedup rests on: a slot's fingerprint from the
    suffix-hash rows equals the one from its counts (sum over columns
    >= the next read's start of counts * H, mod 2^32)."""
    al, wt, nr, ep, npt, P, W, A, window = _frontier_case(case)
    G, R, S = al.shape
    rstart, lo, hi = (x.numpy() for x in TB.frontier_bounds(
        torch.from_numpy(al), torch.from_numpy(nr)))
    cov = al >= 0
    for g in range(G):
        for r in range(R):
            cols = np.flatnonzero(cov[g, r])
            assert rstart[g, r] == (cols[0] if len(cols) else S)
        for t in range(nr[g]):
            later = cov[g, t:nr[g]].any(axis=0)
            upto = cov[g, :t + 1].any(axis=0)
            assert not later[:lo[g, t]].any()
            assert not upto[hi[g, t]:].any()
            assert lo[g, t] == (np.flatnonzero(later)[0] if later.any()
                                else S)
            assert hi[g, t] == (np.flatnonzero(upto)[-1] + 1
                                if upto.any() else 0)
    if window:
        TB._check_windows(torch.from_numpy(al), torch.from_numpy(nr),
                          window)

    result, _asg = TB.beam_search_traceback(al, wt, nr, ep, npt, P, W,
                                            max_alleles=A, window=window,
                                            device="cpu")
    T1 = min(constants.BEAM_WARMUP_READS, R)
    wq = (torch.from_numpy(wt) * np.float32(TB.WEIGHT_SCALE)).to(
        torch.int64).numpy()
    hs, _gs = state.dedup_hash_consts(A, S, P)
    zrows = TB._zrows(torch.from_numpy(al), torch.from_numpy(wt),
                      torch.from_numpy(rstart), [
                          torch.from_numpy(h.astype(np.int64)) for h in hs
                      ]).numpy()
    onehot = (al[..., None] == np.arange(A)).astype(np.int64)  # [G,R,S,A]
    for g in range(G):
        steps = sorted({0, 1, T1 - 1, T1, nr[g] // 2, nr[g] - 2})
        for t in (t for t in steps if 0 <= t < nr[g] - 1):
            ch = _chains(result, g, t, T1)
            for o in range(len(ch)):
                for q in range(P):
                    rows = np.flatnonzero(ch[o] == q)
                    c = np.einsum("rs,rsa->sa", wq[g, rows],
                                  onehot[g, rows])
                    assert not c[hi[g, t]:].any()
                    for f in range(len(hs)):
                        s0 = rstart[g, t + 1]
                        want = int(zrows[g, f, t + 1, rows].sum()) & MASK
                        got = int((c[s0:] * hs[f].T.astype(np.int64)[s0:]
                                   & MASK).sum()) & MASK
                        assert got == want, (g, t, o, q, f)


def pad_batch(arrays, G_pad):
    """numpy arrays padded on axis 0 to G_pad rows with copies of the
    first, as the JAX sweep pads a dispatch. Instances are independent,
    so the first rows' results do not change; jit calls at the padded
    sizes share their compiles."""
    return [np.concatenate([a, np.repeat(a[:1], G_pad - len(a), axis=0)])
            for a in arrays]


def jax_beam_flips(dispatches):
    """Recorded beam dispatches (chip_smoke.DispatchRecorder's `beam`:
    (inputs, P, W, kwargs, (result, assignments)) of the port's sweep)
    against the JAX beam, `_beam_search_batch_mixed_jit` and
    `traceback_batch` on JAX's CPU backend, instance by instance, the
    JAX beam on the batch padded to a power of two (pad_batch; dispatches
    of a shape bucket then share compiles, and a batch of one or two
    long-read blocks is not multiplied). Returns (instances compared,
    [(dispatch, instance)] whose parent or part records, scores, live
    flags or final assignment differ)."""
    n, flips = 0, []
    for d, ((al, wt, nr, ep, npt), P, W, kw, (res, asg)) in enumerate(
            dispatches):
        args = [t.cpu().numpy() for t in (al, wt, nr, ep, npt)]
        G = len(args[0])
        with jax.enable_x64():
            ref = B._beam_search_batch_mixed_jit(
                *pad_batch(args, 1 << (G - 1).bit_length()), P, W,
                kw["max_alleles"], kw["window"], kw.get("dedup", True))
            ref_asg = np.asarray(B.traceback_batch(ref))[:G]
        ref = [np.asarray(a)[:G] for a in ref]
        got = [t.cpu().numpy() for t in res]
        asg = asg.cpu().numpy()
        assert [a.dtype for a in got] == [a.dtype for a in ref]
        assert [a.shape for a in got] == [a.shape for a in ref]
        assert asg.dtype == ref_asg.dtype and asg.shape == ref_asg.shape
        for g in range(al.shape[0]):
            n += 1
            if not (all(np.array_equal(a[g], b[g]) for a, b in zip(ref, got))
                    and np.array_equal(ref_asg[g], asg[g])):
                flips.append((d, g))
    return n, flips


def test_recorded_sweep_dispatches_match_jax_decision_by_decision(
        tmp_path):
    """The port's CLI on long3 (CPU): every beam dispatch of its sweep,
    as recorded, against the JAX beam instance by instance; a record
    changed in one instance is counted as one flip."""
    import chip_smoke

    entry = chip_smoke.load_north_star()["configs"]["long3"]
    sim_dir = str(tmp_path / "long3")
    chip_smoke.simulate_case(entry, sim_dir)
    with chip_smoke.DispatchRecorder() as rec:
        chip_smoke.run_cli(sim_dir, str(tmp_path / "out"), device="cpu",
                           extra=chip_smoke.case_args(entry, sim_dir))
    assert {P for _i, P, *_rest in rec.beam} >= {2, 3}
    n, flips = jax_beam_flips(rec.beam)
    assert n >= len(rec.beam) > 0 and flips == []
    inputs, P, W, kw, (res, asg) = rec.beam[-1]
    main_parts = res.main_parts.clone()
    main_parts[-1, 0, 0] ^= 1
    _n, flips = jax_beam_flips(
        [(inputs, P, W, kw, (res._replace(main_parts=main_parts), asg))])
    assert flips == [(0, inputs[0].shape[0] - 1)]


def test_cuda_tensor_without_card_raises():
    """A CUDA request never falls back to the plain path."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = _pallas_inputs(*PALLAS_CASES[1][:4], 1, (2, 2))
    with pytest.raises(RuntimeError):
        TB.beam_search_traceback(*args, 2, 10, max_alleles=2,
                                 device="cuda")
