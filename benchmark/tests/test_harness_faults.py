"""A whole run, with the look for a card skipped and the program on its
CPU path, at a size a test run holds: sound, it is correct; with the
timed path broken underneath, it is not. The faults a cell can have: a
step that returns its state unchanged, half of the batch left out, and an
answer altered where it is produced (the cells run on one card, so there
is no exchange between cards to leave out)."""

import tempfile
import time

import numpy as np
import pytest

from conftest import SMALL_BLOCKS, SMALL_COMMUNITY, small_root

from harness import runner
from harness.manifest import Manifest

BLOCKS = {"blocks": dict(SMALL_BLOCKS["blocks"], check_blocks=4)}


class _Api:
    """The instance API with one fault planted."""

    def __init__(self, local, fault):
        self.local, self.fault = local, fault

    def phase_instances(self, blocks, options, ploidies, **kw):
        if self.fault == "half":
            blocks = blocks[:len(blocks) // 2]
        out = self.local.phase_instances(blocks, options, ploidies, **kw)
        if self.fault == "altered":
            for key, a in out.items():
                a = a.copy()
                a[0] = (a[0] + 1) % key[1]
                out[key] = a
        return out

    def refine_instances(self, blocks, assignments, options, **kw):
        if self.fault == "half":
            blocks = blocks[:len(blocks) // 2]
        refined, stats = self.local.refine_instances(blocks, assignments,
                                                     options, **kw)
        if self.fault == "unchanged":
            refined = {k: (assignments[k] if k[1] > 1 else v)
                       for k, v in refined.items()}
        return refined, stats


def _blocks_fault(fault):
    def patch(driver, ctx):
        if fault is not None:
            ctx["local"] = _Api(ctx["local"], fault)
    return patch


def _sweep_fault(fault, monkeypatch):
    from floria_tpu_torch.phase import local

    sweep, climb = local.adaptive_sweep, local.upem_optimize_device

    def altered(blocks, options, *a, **k):
        chosen, mec, exp = sweep(blocks, options, *a, **k)
        key = blocks[0][0]
        best, asg = chosen[key]
        asg = asg.copy()
        asg[0] = (asg[0] + 1) % max(best, 2)
        chosen[key] = (max(best, 2), asg)
        return chosen, mec, exp

    def half(blocks, options, *a, **k):
        keep = blocks[:len(blocks) // 2]
        chosen, mec, exp = sweep(keep, options, *a, **k)
        for key, bt in blocks[len(keep):]:
            chosen[key] = (1, np.zeros(bt.num_reads, np.int32))
            mec[key] = exp[key] = np.zeros(options.max_ploidy)
        return chosen, mec, exp

    def unchanged(alleles, weights, assign0, num_reads, epsilon, ploidy,
                  max_alleles, *, device):
        """The climb returns its start, with the start's statistics."""
        _best, _mec, diff = climb(alleles, weights, assign0, num_reads,
                                  epsilon, ploidy, max_alleles, device=device)
        return assign0, local.upem_eval("mec", alleles, weights, assign0,
                                        epsilon, ploidy, max_alleles), diff

    def patch(driver, ctx):
        if fault == "unchanged":
            monkeypatch.setattr(local, "upem_optimize_device", unchanged)
        elif fault is not None:
            monkeypatch.setattr(local, "adaptive_sweep",
                                {"altered": altered, "half": half}[fault])
    return patch


@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered"])
def test_blocks_run_catches_each_fault(tmp_path, fault):
    m = Manifest(root=small_root(tmp_path, "ecoli2", **BLOCKS))
    res = runner.run_cell(m, "ecoli2.blocks", 2**33 + 7, 0.5, False, "cpu",
                          time.perf_counter(), patch=_blocks_fault(fault))
    assert res["correct"] is (fault is None), res["checks"]
    assert res["attempted"] >= 1 and res["metrics"]["api_reads_per_s"]


@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered"])
def test_cli_run_catches_each_fault(tmp_path, monkeypatch, fault):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    m = Manifest(root=small_root(tmp_path, "config4", **SMALL_COMMUNITY))
    res = runner.run_cell(m, "config4.cli", 2**33 + 7, 2.5, False, "cpu",
                          time.perf_counter(),
                          patch=_sweep_fault(fault, monkeypatch))
    assert res["correct"] is (fault is None), res["checks"]
    assert res["metrics"]["cli_reads_per_s"]["value"] > 0
