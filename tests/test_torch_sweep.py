"""The port's adaptive ploidy sweep (plain path, CPU) against the JAX
reference's, bitwise on chosen ploidies, assignments, MEC vectors and
expected-error vectors; the fused level-1+2 wave against the sequential
schedule; dispatch-cap chunking output-invariant."""

import dataclasses

import numpy as np
import pytest
import torch

from __graft_entry__ import _synth_blocks
from floria_tpu.kernels.blocktensor import pack_block
from floria_tpu.options import Options
from floria_tpu.phase import local as L
from floria_tpu_torch.phase import local as TL
from test_kernels import _random_frags

# One intra-op thread: the suite runs several pytest workers on one
# host, and oversubscribed OpenMP threads slow every worker down.
torch.set_num_threads(1)


def _blocks(n, seed):
    """__graft_entry__._synth_blocks at R=64, S=256, ploidy <= 4, with
    each block's rows cut to its live reads (pack_block's layout)."""
    out = []
    for j, bt in _synth_blocks(n, 64, 256, 4, seed=seed):
        r = bt.num_reads
        out.append((j, dataclasses.replace(
            bt, alleles=bt.alleles[:r], weights=bt.weights[:r],
            quals=bt.quals[:r], frag_ids=bt.frag_ids[:r])))
    return out


def _assert_sweeps_equal(a, b):
    ca, ma, ea = a
    cb, mb, eb = b
    assert set(ca) == set(cb)
    for k in ca:
        assert ca[k][0] == cb[k][0], k
        np.testing.assert_array_equal(ca[k][1], cb[k][1])
        assert ca[k][1].dtype == cb[k][1].dtype
        np.testing.assert_array_equal(ma[k], mb[k])
        np.testing.assert_array_equal(ea[k], eb[k])


@pytest.mark.parametrize("seed", [1, 2])
def test_adaptive_sweep_matches_jax(seed):
    blocks = _blocks(6, seed)
    opts = Options(epsilon=0.02, max_ploidy=4)
    want = L.adaptive_sweep(blocks, opts)
    got = TL.adaptive_sweep(blocks, opts, device="cpu")
    _assert_sweeps_equal(want, got)
    assert len({v[0] for v in got[0].values()}) > 1


def test_fused_level12_matches_sequential_schedule(monkeypatch):
    """The port always fuses levels 1+2; the reference's speculative
    path (FLORIA_SWEEP_SPEC=1) keeps the sequential per-level schedule.
    Includes blocks that stop at level 1."""
    blocks = []
    for j in range(8):
        rng = np.random.default_rng(130 + j)
        if j % 4 == 0:
            frags = _random_frags(rng, 28, 56, 1, eps=0.0)
        else:
            frags = _random_frags(rng, 28, 56, 2 + j % 3)
        blocks.append(((0, j), pack_block(frags, (1, 56))))
    opts = Options(epsilon=0.02, max_ploidy=4)
    monkeypatch.setenv("FLORIA_SWEEP_SPEC", "1")
    want = L.adaptive_sweep(blocks, opts)
    got = TL.adaptive_sweep(blocks, opts, device="cpu")
    assert 1 in {v[0] for v in got[0].values()}
    _assert_sweeps_equal(want, got)


def test_dispatch_cap_chunking_is_output_invariant(monkeypatch):
    blocks = _blocks(10, 3)
    opts = Options(epsilon=0.02, max_ploidy=4)
    base = TL.adaptive_sweep(blocks, opts, device="cpu")
    # Two instances per dispatch instead of all ten.
    monkeypatch.setenv("FLORIA_SWEEP_CAP_CELLS", str(2 * 64 * 256))
    assert TL._sweep_cap_cells(opts) == 2 * 64 * 256
    chunked = TL.adaptive_sweep(blocks, opts, device="cpu")
    _assert_sweeps_equal(base, chunked)


def test_dispatch_holds_each_instance_once(monkeypatch):
    """Each dispatch carries exactly its blocks: no padding instances in
    the beam scan, and cache rows equal to the bucket's member count."""
    blocks = _blocks(5, 4)
    opts = Options(epsilon=0.02, max_ploidy=3)
    seen = []
    orig = TL.beam_kernel.beam_search_traceback

    def spy(alleles, *args, **kw):
        seen.append(alleles.shape[0])
        return orig(alleles, *args, **kw)

    monkeypatch.setattr(TL.beam_kernel, "beam_search_traceback", spy)
    cache = TL.BlockDeviceCache(blocks, device="cpu")
    assert sum(a.shape[0] for a, _q in cache.dev.values()) == len(blocks)
    got = TL.adaptive_sweep(blocks, opts, cache, device="cpu")
    # One beam instance per block in the fused level-1+2 wave, then one
    # per (block, level >= 3) that ran: its expected errors were filled.
    assert seen[0] == len(blocks)
    later = sum(int((e[2:] > 0).sum()) for e in got[2].values())
    assert later > 0
    assert sum(seen[1:]) == later
    _assert_sweeps_equal(L.adaptive_sweep(blocks, opts), got)


def test_sweep_cap_default_and_precedence(monkeypatch):
    monkeypatch.delenv("FLORIA_SWEEP_CAP_CELLS", raising=False)
    assert TL._sweep_cap_cells(Options()) == 1 << 26
    assert TL._sweep_cap_cells(Options(sweep_cap="4096")) == 4096
    monkeypatch.setenv("FLORIA_SWEEP_CAP_CELLS", "77")
    assert TL._sweep_cap_cells(Options(sweep_cap="4096")) == 77


@pytest.mark.parametrize("seed", range(4))
def test_stopping_rule_helpers_match_jax(seed):
    """The port's copies of pick_best_ploidy / _sweep_decide equal the
    reference's on random MEC vectors, every sensitivity and heuristic."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        mec = rng.uniform(0, 50, 5) * (rng.random(5) > 0.1)
        exp = rng.uniform(0, 20, 5)
        opts = Options(epsilon=float(rng.uniform(0.005, 0.1)),
                       ploidy_sensitivity=int(rng.integers(1, 4)),
                       stopping_heuristic=bool(rng.random() < 0.7))
        assert TL.pick_best_ploidy(mec, exp, opts) == \
            L.pick_best_ploidy(mec, exp, opts)
        for p in range(1, 6):
            assert TL._sweep_decide(mec, exp, p, opts) == \
                L._sweep_decide(mec, exp, p, opts)
        assert TL._bucket_reads(int(mec[0]) + 1) == \
            L._bucket_reads(int(mec[0]) + 1)
        assert TL._bucket_sites(int(mec[1] * 40) + 1) == \
            L._bucket_sites(int(mec[1] * 40) + 1)
