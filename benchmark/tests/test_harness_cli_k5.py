"""The `ecoli2.cli` path with realignment on the device NW (`nw_best`,
its plain version on the CPU), held to the plain reference: a small
community of `ecoli2_cli`'s shape (2 strains, 9 kbp reads at 50x each) run
through the CLI driver with CPP_MAX_JOBS below its unique job count;
and the float32 control, which the same comparison finds not correct."""

import tempfile
import time

from conftest import SMALL_COMMUNITY, small_root

from harness import runner
from harness.manifest import Manifest


def test_the_k5_path_writes_the_references_texts_and_sweep(tmp_path,
                                                          monkeypatch):
    from floria_tpu_torch.kernels import realign

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    sizes = []
    plain = realign.nw_best

    def counted(q, *rest):
        sizes.append(len(q))
        return plain(q, *rest)

    monkeypatch.setattr(realign, "nw_best", counted)
    monkeypatch.setattr(realign, "CPP_MAX_JOBS", 1000)
    m = Manifest(root=small_root(tmp_path, "ecoli2_cli", **SMALL_COMMUNITY))
    res = runner.run_cell(m, "ecoli2.cli", 2**33 + 19, 0.5, False, "cpu",
                          time.perf_counter())
    # Every job of the run (the warm one included) sent a partition of
    # more than CPP_MAX_JOBS unique jobs to nw_best.
    assert len(sizes) >= 2 and min(sizes) > 1000, sizes
    checks = {n: c["value"] for n, c in res["checks"].items()}
    assert checks == {"texts_differ": 0, "blocks_differ": 0,
                      "mec_differ": 0, "jobs_unchecked": 0}
    assert res["correct"] and res["failed"] == 0


def test_the_float32_control_is_not_correct_on_ecoli2_cli(tmp_path,
                                                          monkeypatch):
    from harness import control

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    m = Manifest(root=small_root(tmp_path, "ecoli2_cli", **SMALL_COMMUNITY))
    nums = control.control_numbers(m, "ecoli2.cli", 3)
    assert nums["mec_differ"] > 0, nums
