"""The port held to the JAX package decision by decision on the CPU
(tests/test_torch_decisions_a.py's holds: sweep, beam, climb and the
ploidy-1 MEC) on fuzz seeds 3 and 4, and on the sharded path: fuzz2
through the CLI with its dispatches split over 8 CPU shards. The other
small configs are in tests/test_torch_decisions_a.py and _b.py, so that
pytest-xdist's --dist loadfile runs them on other workers."""

import pytest
import torch

from test_torch_decisions_a import (HOLDS, assert_holds,  # noqa: F401
                                    record_config, recordings)

# One intra-op thread: the suite runs several pytest workers on one
# host, and oversubscribed OpenMP threads slow every worker down.
torch.set_num_threads(1)

CONFIGS = ["fuzz3", "fuzz4"]


@pytest.mark.parametrize("hold", HOLDS)
@pytest.mark.parametrize("name", CONFIGS)
def test_decisions_match_jax(name, hold, recordings):  # noqa: F811
    rec = recordings(name)
    assert rec.sweeps and rec.beams and rec.climbs.climbs
    assert len(rec.climbs.climbs) == len(rec.beams)
    assert_holds(name, rec, (hold,))


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """fuzz2 through the port's CLI with `--num-devices 8`: each sweep
    dispatch split into contiguous shards over 8 CPU devices, each
    shard's chain on its own host thread."""
    return record_config("fuzz2", str(tmp_path_factory.mktemp("sharded")),
                         extra=["--num-devices", "8"])


@pytest.mark.parametrize("hold", HOLDS)
def test_sharded_decisions_match_jax(hold, sharded):
    """The JAX sweep runs with the recorded Options (num_devices 8), so
    over JAX's 8-device CPU mesh."""
    assert sharded.sweeps[0][1].num_devices == 8
    assert len(sharded.beams) == len(sharded.climbs.climbs)
    assert max(d[0][0].shape[0] for d in sharded.beams) == 1
    assert_holds("fuzz2 over 8 shards", sharded, (hold,))
