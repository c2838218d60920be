"""The port held to the JAX package decision by decision on the CPU
(tests/test_torch_decisions_a.py's holds: sweep, beam, climb and the
ploidy-1 MEC) on hybrid and fuzz seeds 0-2, and on the sweep of
entry.dryrun_multichip over 8 CPU shards. The other small configs are
in tests/test_torch_decisions_a.py and _c.py, so that pytest-xdist's
--dist loadfile runs them on other workers."""

import pytest
import torch

import chip_smoke
from floria_tpu_torch import entry
from test_torch_decisions_a import (HOLDS, assert_holds,  # noqa: F401
                                    jax_sweep_flips, recordings)

# One intra-op thread: the suite runs several pytest workers on one
# host, and oversubscribed OpenMP threads slow every worker down.
torch.set_num_threads(1)

CONFIGS = ["hybrid", "fuzz0", "fuzz1", "fuzz2"]


@pytest.mark.parametrize("hold", HOLDS)
@pytest.mark.parametrize("name", CONFIGS)
def test_decisions_match_jax(name, hold, recordings):  # noqa: F811
    rec = recordings(name)
    assert rec.sweeps and rec.beams and rec.climbs.climbs
    assert len(rec.climbs.climbs) == len(rec.beams)
    assert_holds(name, rec, (hold,))


def test_entry_dryrun_sweep_matches_jax():
    """The sweep entry.dryrun_multichip runs over 8 CPU shards, recorded
    where the entry calls it, against the JAX sweep block by block."""
    with chip_smoke.SweepRecorder() as rec:
        entry.dryrun_multichip(8, device=[torch.device("cpu")] * 8)
    assert len(rec.sweeps) == 1 and rec.sweeps[0][3] is None
    n, flips = jax_sweep_flips(rec.sweeps)
    assert n == 16 and flips == []
