"""The benchmark's own tests (run with `python -m pytest benchmark/tests`
from the root of the checkout): the manifest, the generators, the plain
reference against the program's CPU path, and the comparison against
planted faults. None needs a card except those marked `cuda`."""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]


@pytest.fixture(autouse=True, scope="session")
def _one_thread():
    import torch

    torch.set_num_threads(1)


def small_root(tmp_path, config: str, **changes) -> str:
    """A checkout root under tmp_path whose BENCHMARK.json is the real one
    and whose configuration `config` has `changes` applied, section by
    section ({"sim": {...}, "blocks": {...}, "cli": {...}})."""
    os.makedirs(tmp_path / "benchmark" / "configs", exist_ok=True)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    with open(os.path.join(BENCH, "configs", f"{config}.json")) as fh:
        cfg = json.load(fh)
    for section, values in changes.items():
        cfg[section].update(values)
    with open(tmp_path / "benchmark" / "configs" / f"{config}.json",
              "w") as fh:
        json.dump(cfg, fh)
    return str(tmp_path)


SMALL_BLOCKS = {"blocks": {"num_blocks": 4, "reads_per_block": 60,
                           "block_sites": 60, "read_length": 1600,
                           "read_length_sd": 300.0, "check_blocks": 3}}
SMALL_COMMUNITY = {"sim": {"contig_len": 40000, "num_snps": 1200},
                   "cli": {"pool": 2}}
