"""The PyTorch port's UPEM (plain path, CPU) against the JAX reference,
bitwise: move evaluation, unit-weight MEC stats, the move walk and the
whole hill-climb, at ploidies 2 and 3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from floria_tpu.kernels import upem_batch as U
from floria_tpu_torch.kernels import upem_batch as TU
from test_upem_batch import _mk_block

# One intra-op thread: the suite runs several pytest workers on one
# host, and oversubscribed OpenMP threads slow every worker down.
torch.set_num_threads(1)

EPS = round(0.03 * 67108864.0) / 67108864.0


def _batch(ploidy, seed, G=3, pad=3):
    bts = [_mk_block(seed + k, ploidy=ploidy) for k in range(G)]
    R = max(b.alleles.shape[0] for b in bts) + pad
    S = max(b.alleles.shape[1] for b in bts)
    alleles = np.full((G, R, S), -1, np.int8)
    weights = np.zeros((G, R, S), np.float32)
    nreads = np.zeros(G, np.int32)
    for g, b in enumerate(bts):
        r, s = b.alleles.shape
        alleles[g, :r, :s] = b.alleles
        weights[g, :r, :s] = b.weights
        nreads[g] = b.num_reads
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, ploidy, (G, R)).astype(np.int32)
    assign[:, -1] = -1           # a padding row as the traceback leaves it
    eps = np.full(G, EPS, np.float32)
    return alleles, weights, assign, nreads, eps


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


CASES = [(2, 0), (2, 21), (3, 7), (3, 40)]


@pytest.mark.parametrize("ploidy,seed", CASES)
def test_eval_diff_score_and_mec_match_jax(ploidy, seed):
    alleles, weights, assign, _nr, eps = _batch(ploidy, seed)
    with jax.enable_x64():
        d, s = U._eval_diff_score(jnp.asarray(alleles), jnp.asarray(weights),
                                  jnp.asarray(assign), jnp.asarray(eps),
                                  ploidy, 2)
        m = U._eval_mec(jnp.asarray(alleles), jnp.asarray(assign),
                        jnp.asarray(eps), ploidy, 2)
    ta, tw, tasg, te = _t(alleles, weights, assign, eps)
    td, ts = TU._eval_diff_score(ta, tw, tasg, te, ploidy, 2)
    tm = TU._eval_mec(ta, tasg, te, ploidy, 2)
    for a, b in ((d, td), (s, ts), (m, tm)):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("ploidy,seed", CASES)
def test_apply_moves_matches_vmapped_jax(ploidy, seed):
    alleles, weights, assign, nreads, eps = _batch(ploidy, seed)
    with jax.enable_x64():
        d, _s = U._eval_diff_score(jnp.asarray(alleles), jnp.asarray(weights),
                                   jnp.asarray(assign), jnp.asarray(eps),
                                   ploidy, 2)
        want = np.asarray(jax.vmap(U._apply_moves_single)(
            jnp.asarray(assign), d, jnp.asarray(nreads)))
    got = TU.apply_moves(torch.from_numpy(assign),
                         torch.from_numpy(np.array(d)),
                         torch.from_numpy(nreads))
    assert (want != assign).any()
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("ploidy,seed", CASES)
def test_upem_optimize_matches_jax(ploidy, seed):
    alleles, weights, assign, nreads, eps = _batch(ploidy, seed)
    want = U.upem_optimize_device(alleles, weights, assign, nreads, eps,
                                  ploidy, max_alleles=2)
    got = TU.upem_optimize_device(alleles, weights, assign, nreads, eps,
                                  ploidy, max_alleles=2, device="cpu")
    for a, b in zip(want, got):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
