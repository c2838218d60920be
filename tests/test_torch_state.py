"""The constants the port carries across equal the JAX package's."""

import numpy as np
import pytest
import torch

from floria_tpu.kernels import beam as B
from floria_tpu_torch import state


def test_phred_table_matches_reference():
    got = state.phred_table()
    assert got.dtype == B._PHRED_TABLE.dtype
    np.testing.assert_array_equal(got, B._PHRED_TABLE)


@pytest.mark.parametrize("A,S,P", [(2, 64, 2), (4, 2048, 5), (3, 130, 7)])
def test_dedup_hash_consts_match_reference(A, S, P):
    hs, gs = state.dedup_hash_consts(A, S, P)
    rhs, rgs = B._hash_consts_np(A, S, P)
    assert len(hs) == len(rhs) == state.NUM_FINGERPRINTS
    for a, b in zip(hs + gs, rhs + rgs):
        assert a.dtype == b.dtype == np.uint32
        np.testing.assert_array_equal(a, b)


def test_from_reference_tensors():
    rhs, rgs = B._hash_consts_np(2, 32, 3)
    h, g, p = state.from_reference(rhs, rgs, B._PHRED_TABLE, "cpu")
    assert h.dtype == g.dtype == torch.int64
    np.testing.assert_array_equal(h.numpy(), np.stack(rhs).astype(np.int64))
    np.testing.assert_array_equal(g.numpy(), np.stack(rgs).astype(np.int64))
    np.testing.assert_array_equal(p.numpy(), B._PHRED_TABLE)
