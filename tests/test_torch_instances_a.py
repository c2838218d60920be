"""The port's instance API (plain path, CPU) against the JAX package on
JAX's CPU backend, part a: the fixed-ploidy beam and its host traceback
(`beam_search_batch`, `traceback`), `parallel.mesh.pad_to_multiple`, and
the native bridge's `baseline_sweep` and `pack_windows`.

The beam cases are the JAX package's own: test_kernels.py's
oracle-exact cases (through `phase_instances`, also against
`oracle.beam_search`) and its dedup-teeth instance, test_windowed_beam's
windows 256 and 384, test_mixed_ploidy's mixed batch against fixed
ploidies, and seeds of test_phred0_dedup. Records, scores, live flags
and assignments are compared bitwise (dtype and bytes): the beam's f64
scores are integer weight quanta, so no value here depends on a
backend's `log`.

The native functions run the same C++ (`native/`) through both
packages' ctypes wrappers: the JAX wrapper is bound, with its own
`_bind`, to a handle of the port's build of the library, so the two
differ only in their Python marshalling.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

import oracle
from floria_tpu import native as JN
from floria_tpu.frag import Frag
from floria_tpu.kernels import beam as B
from floria_tpu.kernels.blocktensor import pack_block
from floria_tpu.options import Options as JaxOptions
from floria_tpu.parallel import mesh as JM
from floria_tpu.phase import local as JL
from floria_tpu_torch import native as TN
from floria_tpu_torch.kernels import beam as TB
from floria_tpu_torch.kernels.blocktensor import BlockTensor
from floria_tpu_torch.options import Options
from floria_tpu_torch.parallel import mesh as TM
from floria_tpu_torch.phase import local as TL
from test_kernels import _mk_frag, _random_frags
from test_mixed_ploidy import _toy
from test_phred0_dedup import _DIVERGENT, EPS as EPS_GRID, _gen_qual0_frags
from test_windowed_beam import _long_block

# One intra-op thread: the suite runs several pytest workers on one
# host, and oversubscribed OpenMP threads slow every worker down.
torch.set_num_threads(1)


def port_blocks(blocks):
    """[(key, BlockTensor)] of either package as the port's (the two
    classes are field-for-field copies)."""
    names = [f.name for f in dataclasses.fields(BlockTensor)]
    return [(key, BlockTensor(**{n: getattr(bt, n) for n in names}))
            for key, bt in blocks]


def _same(a, b) -> bool:
    """Bitwise: dtype, shape and bytes (tensors compared on the host)."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def _assert_results_same(want, got):
    for name, a, b in zip(want._fields, want, got):
        assert _same(a, b), name


@pytest.mark.parametrize("n,m", [(0, 8), (1, 8), (8, 8), (9, 8), (115, 4),
                                 (7, 1)])
def test_pad_to_multiple_matches_jax(n, m):
    assert TM.pad_to_multiple(n, m) == JM.pad_to_multiple(n, m)


@pytest.mark.parametrize("ploidy,seed", [(2, 2), (3, 5), (2, 9), (4, 1),
                                         (5, 7)])
def test_phase_instances_matches_jax_and_the_oracle_exactly(ploidy, seed):
    """test_kernels.py::test_beam_kernel_matches_oracle_exactly's cases:
    the port's `phase_instances` equals the JAX package's and the exact
    oracle's assignment read for read."""
    rng = np.random.default_rng(seed)
    frags = _random_frags(rng, 60, 40, ploidy)
    want = oracle.beam_search([oracle.frag_to_read(f) for f in frags],
                              ploidy, 0.03, beam_width=10)
    bt = pack_block(frags, (1, 40))
    jax_got = JL.phase_instances(
        [(0, bt)], JaxOptions(epsilon=0.03, max_number_solns=10),
        ploidies=[ploidy])[(0, ploidy)]
    got = TL.phase_instances(
        port_blocks([(0, bt)]), Options(epsilon=0.03, max_number_solns=10),
        ploidies=[ploidy], device="cpu")
    assert list(got) == [(0, ploidy)]
    assert _same(got[(0, ploidy)], jax_got)
    assert list(got[(0, ploidy)]) == list(want)


def _dedup_block():
    """test_kernels.py::test_beam_dedup_has_teeth's instance: one early
    short read, then reads far downstream."""
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
    return frags, pack_block(frags, (1, 60)), ploidy


@pytest.mark.parametrize("dedup", [True, False])
def test_dedup_case_beam_and_traceback_match_jax_and_the_oracle(dedup):
    frags, bt, ploidy = _dedup_block()
    args = (bt.alleles[None], bt.weights[None],
            np.array([bt.num_reads], np.int32),
            np.array([0.03], np.float32))
    want = B.beam_search_batch(*args, ploidy=ploidy, beam_width=10,
                               dedup=dedup)
    got = TB.beam_search_batch(*args, ploidy=ploidy, beam_width=10,
                               dedup=dedup, device="cpu")
    _assert_results_same(want, got)
    a_jax = B.traceback(tuple(np.asarray(a)[0] for a in want),
                        bt.num_reads, ploidy)
    a_port = TB.traceback(tuple(x[0] for x in got), bt.num_reads, ploidy)
    assert _same(a_port, a_jax)
    oracle_a = oracle.beam_search([oracle.frag_to_read(f) for f in frags],
                                  ploidy, 0.03, beam_width=10)
    # With the dedup the beam is the oracle's; without it duplicate
    # slots crowd out distinct ones (the JAX package's teeth test).
    assert (list(a_port) == list(oracle_a)) == dedup


@pytest.mark.parametrize("window", [256, 384])
def test_windowed_beam_matches_jax_and_full_width(window):
    args = _long_block()
    want = B.beam_search_batch(*args, ploidy=2, beam_width=6, window=window)
    got = TB.beam_search_batch(*args, ploidy=2, beam_width=6, window=window,
                               device="cpu")
    _assert_results_same(want, got)
    full = TB.beam_search_batch(*args, ploidy=2, beam_width=6, device="cpu")
    _assert_results_same(full, got)


def test_mixed_ploidy_matches_fixed_ploidy_and_jax():
    """test_mixed_ploidy.py's batch: each instance of one mixed dispatch
    traces back to the assignment of its own fixed-ploidy dispatch, with
    the fixed beam's live flags and scores in the first num_parts * W
    slots; the fixed-ploidy results equal the JAX package's."""
    G = 6
    args = _toy(G)
    num_parts = np.array([2, 3, 4, 5, 3, 2], np.int32)
    mixed = TB.beam_search_batch_mixed(*args, num_parts, max_ploidy=5,
                                       beam_width=6, device="cpu")
    for g in range(G):
        p = int(num_parts[g])
        one = tuple(a[g:g + 1] for a in args)
        single = TB.beam_search_batch(*one, ploidy=p, beam_width=6,
                                      device="cpu")
        _assert_results_same(B.beam_search_batch(*one, ploidy=p,
                                                 beam_width=6), single)
        nr = int(args[2][g])
        a_mixed = TB.traceback(tuple(x[g] for x in mixed), nr, p)
        a_single = TB.traceback(tuple(x[0] for x in single), nr, p)
        np.testing.assert_array_equal(a_mixed, a_single, err_msg=f"g={g}")
        live = single.live[0]
        assert torch.equal(mixed.live[g, :len(live)], live)
        assert torch.equal(mixed.scores[g, :len(live)][live],
                           single.scores[0][live])


@pytest.mark.parametrize("seed,beam_width",
                         _DIVERGENT[:3] + [(0, 2), (5, 1), (17, 2)])
def test_phred0_dedup_matches_jax_and_the_zero_strip_oracle(seed,
                                                            beam_width):
    frags = _gen_qual0_frags(seed)
    bt = pack_block(frags, (1, 8))
    args = (bt.alleles[None], bt.weights[None],
            np.array([bt.num_reads], np.int32),
            np.array([EPS_GRID], np.float32))
    want = B.beam_search_batch(*args, ploidy=2, beam_width=beam_width)
    got = TB.beam_search_batch(*args, ploidy=2, beam_width=beam_width,
                               device="cpu")
    _assert_results_same(want, got)
    a_port = TB.traceback(tuple(x[0] for x in got), bt.num_reads, 2)
    assert _same(a_port, B.traceback(tuple(np.asarray(a)[0] for a in want),
                                     bt.num_reads, 2))
    strip = oracle.beam_search([oracle.frag_to_read(f) for f in frags], 2,
                               EPS_GRID, beam_width=beam_width,
                               zero_strip=True)
    assert list(a_port) == strip


def test_traceback_takes_tensors_or_arrays_and_the_first_best_slot():
    """The host walk reads numpy arrays or tensors alike, and on tied
    best scores takes the first live slot (np.argmin), as JAX's."""
    args = _toy(2, seed=4)
    res = TB.beam_search_batch(*args, ploidy=3, beam_width=4, device="cpu")
    rec = tuple(x[1] for x in res)
    as_np = tuple(x.numpy() for x in rec)
    nr = int(args[2][1])
    assert _same(TB.traceback(rec, nr, 3), TB.traceback(as_np, nr, 3))
    tied = list(as_np)
    tied[4] = np.zeros_like(tied[4])
    tied[5] = np.ones_like(tied[5])
    assert _same(TB.traceback(tied, nr, 3), B.traceback(tied, nr, 3))


@pytest.fixture
def jax_native(monkeypatch):
    """The JAX package's native wrappers on a handle of the port's build
    of the same sources, bound by the JAX package's own `_bind`."""
    TN.get_lib()
    lib = ctypes.CDLL(TN.LIB_PATH)
    JN._bind(lib)
    monkeypatch.setattr(JN, "get_lib", lambda: lib)
    return JN


@pytest.mark.parametrize("faithful", [True, False])
def test_baseline_sweep_matches_jax(jax_native, faithful):
    from floria_tpu_torch.bench import make_workload

    alleles, weights, _nr, eps = make_workload(3, 24, 64, seed=5)
    eps0 = float(eps[0])
    for kw in ({}, {"want_assign": True}, {"want_assign": True,
                                           "do_upem": True}):
        want = jax_native.baseline_sweep(alleles, weights, [2, 3, 4, 5], 10,
                                         eps0, faithful=faithful, **kw)
        got = TN.baseline_sweep(alleles, weights, [2, 3, 4, 5], 10, eps0,
                                faithful=faithful, **kw)
        if kw:
            assert _same(got, want)
            assert got.shape == (3, 24) and (got >= 0).all()
        else:
            assert got == want == 3 * 24


def test_pack_windows_matches_jax(jax_native):
    rng = np.random.default_rng(3)
    seq = rng.choice(np.frombuffer(b"ACGTNacgtRY=", np.uint8), 5000)
    qpos = rng.integers(40, 5000 - 40, 700)
    for flank in (16, 32):
        want = jax_native.pack_windows(seq, qpos, flank)
        got = TN.pack_windows(seq, qpos, flank)
        assert got.shape == (700, flank) and _same(got, want)
