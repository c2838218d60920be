"""The run's guards, and one short run of each cell on a card (marker
`cuda`; skipped without one)."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT


def _run(workload, seconds, trace=0):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(2**31 + 11), "--seconds", str(seconds),
         "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)


def test_without_a_card_the_run_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _run("ecoli2.blocks", 1)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "torch.cuda.is_available() is False" in proc.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["ecoli2.blocks", "config4.cli"])
def test_a_short_run_on_the_card_is_correct(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for trace in (0, 1):
        proc = _run(workload, 3, trace)
        assert proc.returncode == 0, proc.stderr[-4000:]
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        assert res["correct"] and res["device"]["platform"] == "gpu"
        assert res["metrics"]
        if trace:
            assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
