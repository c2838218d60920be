"""The PyTorch port's UPEM (plain path, CPU) against the JAX reference,
bitwise: move evaluation, unit-weight MEC stats, the move function (the
plain version of kernel K4) and the whole hill-climb, at ploidies 2 and
3, plus tie-heavy move cases and the candidate order K4 sorts by."""

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
    args = _t(assign, np.array(d), nreads)
    got = TU.apply_moves_plain(*args)
    assert (want != assign).any()
    np.testing.assert_array_equal(want, got.numpy())
    assert torch.equal(TU.apply_moves(*args), got)   # CPU -> plain


def moves_case(G, R, P, seed, levels=3):
    """(assign [G, R] int32, diff [G, R, P] f64 quanta, num_reads [G]
    int32) with few distinct distances, so many gains tie: padding rows
    (-1), an instance whose distances are all equal and one with no live
    read (n_valid = 0 for both), and a live read whose part is -1."""
    rng = np.random.default_rng(seed)
    diff = rng.integers(0, levels, (G, R, P)).astype(np.float64) * 4096.0
    assign = rng.integers(0, P, (G, R)).astype(np.int32)
    nreads = rng.integers(R // 2, R + 1, G).astype(np.int32)
    for g in range(G):
        assign[g, nreads[g]:] = -1
    diff[1] = 8192.0
    nreads[2] = 0
    assign[3, 0] = -1          # wraps to part P - 1, which it leaves
    diff[3, 0] = 0.0
    diff[3, 0, P - 1] = 4096.0 * levels
    return assign, diff, nreads


def _jax_moves(assign, diff, nreads):
    with jax.enable_x64():
        return np.asarray(jax.vmap(U._apply_moves_single)(
            jnp.asarray(assign), jnp.asarray(diff), jnp.asarray(nreads)))


@pytest.mark.parametrize("P,seed", [(2, 1), (3, 2), (5, 3)])
def test_apply_moves_plain_matches_vmapped_jax_on_ties(P, seed):
    assign, diff, nreads = moves_case(6, 48, P, seed)
    want = _jax_moves(assign, diff, nreads)
    got = TU.apply_moves_plain(*_t(assign, diff, nreads))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())
    n_valid = TU._move_candidates(*_t(assign, diff, nreads))[2]
    assert n_valid[1] == 0 and n_valid[2] == 0 and (n_valid > 0).sum() >= 3
    assert (want != assign).any()
    np.testing.assert_array_equal(want[1:3], assign[1:3])
    assert want[3, 0] == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_composite_key_order_is_the_stable_argsort(seed):
    """K4 sorts the valid candidates by (gain descending, generation index
    ascending); over the valid prefix that is the reference's
    jnp.argsort(where(valid, -gain, inf), stable=True), and the invalid
    candidates follow in generation order."""
    rng = np.random.default_rng(seed)
    K = 700
    gain = rng.integers(-3, 5, K).astype(np.float64) * 4096.0
    valid = (gain > 0) & (rng.random(K) < 0.8)
    with jax.enable_x64():
        want = np.asarray(jnp.argsort(
            jnp.where(jnp.asarray(valid), -jnp.asarray(gain), jnp.inf),
            stable=True))
    k = np.nonzero(valid)[0]
    composite = k[np.lexsort((k, -gain[k]))]
    n = len(k)
    np.testing.assert_array_equal(want[:n], composite)
    np.testing.assert_array_equal(want[n:], np.nonzero(~valid)[0])


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
