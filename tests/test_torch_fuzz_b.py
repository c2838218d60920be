"""The port's pipeline against the JAX package's, byte for byte, on the
last fuzz seeds of tests/test_pipeline_fuzz.py (its `_draw_config` and
Options draws), each JAX output also held to
tests/data/north_star_golden.json. The first seeds are in
tests/test_torch_fuzz_a.py, so that pytest-xdist's --dist loadfile runs
the two halves on two workers."""

import pytest
import torch

from test_torch_oracle_configs import run_both

# One intra-op thread: the suite runs several pytest workers on one
# host, and oversubscribed OpenMP threads slow every worker down.
torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [4, 19])
def test_fuzz_seed_matches_jax(seed, tmp_path):
    run_both(f"fuzz{seed}", tmp_path)
