"""The port never imports jax: not in its sources, not at run time (a
process whose `import jax` raises runs the port's CLI end to end, as on
a host without jax), and `--device cuda` without a card raises."""

import ast
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "floria_tpu_torch")

_CHILD = r"""
import importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError("jax is blocked in this process")
        return None

sys.meta_path.insert(0, Refuse())
sys.path.insert(0, {repo!r})
from floria_tpu.sim.simulate import SimConfig, simulate
simulate(SimConfig(contig_len=20_000, num_strains=2, num_snps=100,
                   coverage_per_strain=8.0, read_length=3_000,
                   read_length_sd=400.0, error_rate=0.01, seed=7),
         {sim!r})
from floria_tpu_torch import cli
cli.main(["-b", {sim!r} + "/sim.bam", "-v", {sim!r} + "/sim.vcf",
          "-r", {sim!r} + "/sim.fa", "-o", {out!r}, "--overwrite",
          "--device", "cpu", "-e", "0.02", "-l", "3000",
          "--snp-count-filter", "10"])
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
print("JAXFREE_OK")
"""


def _sources():
    for d, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(d, f)


def test_no_jax_import_in_sources():
    bad = []
    for path in _sources():
        with open(path) as fh:
            for i, line in enumerate(fh, 1):
                s = line.strip()
                if s.startswith(("import jax", "from jax")):
                    bad.append(f"{path}:{i}")
    assert not bad, bad


def test_cli_runs_with_jax_blocked(tmp_path):
    code = _CHILD.format(repo=REPO, sim=str(tmp_path / "sim"),
                         out=str(tmp_path / "out"))
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "JAXFREE_OK" in proc.stdout
    contig_dir = tmp_path / "out" / "sim_contig"
    assert (contig_dir / "sim_contig.vartigs").stat().st_size > 0


def test_cuda_device_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from floria_tpu_torch import cli

    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["-b", "x.bam", "-v", "x.vcf", "-r", "x.fa",
                  "-o", str(tmp_path / "out"), "--device", "cuda"])


@pytest.mark.parametrize("flag", [["--num-processes", "2"],
                                  ["--num-devices", "2"]])
def test_multi_device_flags_raise(flag, tmp_path):
    from floria_tpu_torch import cli

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(["-b", "x.bam", "-v", "x.vcf", "-r", "x.fa",
                  "-o", str(tmp_path / "out"), "--device", "cpu", *flag])


def test_port_import_loads_no_jax_even_when_installed():
    """jax is importable here; importing the port first must still leave
    it unloaded (floria_tpu's init attempt is refused)."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import floria_tpu_torch.cli, floria_tpu_torch.pipeline\n"
            "import floria_tpu.sim.simulate\n"
            "assert 'jax' not in sys.modules, sorted(\n"
            "    m for m in sys.modules if m.startswith('jax'))\n"
            "import jax\n"
            "print('OK')\n" % REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ, JAX_PLATFORMS="cpu",
                                   OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "OK" in proc.stdout


def test_port_imported_after_jax_leaves_the_reference_intact():
    """The documented import order for A/B runs: jax first, then the
    port; floria_tpu then initialises with x64 as it always does."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import jax\n"
            "import floria_tpu_torch.pipeline\n"
            "assert jax.config.jax_enable_x64\n"
            "print('OK')\n" % REPO)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ, JAX_PLATFORMS="cpu",
                                   OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "OK" in proc.stdout


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield "." * node.level + (node.module or "")


def test_chip_smoke_imports_neither_jax_nor_the_reference():
    """chip_smoke.py reaches the simulator, stage timers and pipeline
    through the port's modules; bench.py (for make_workload) imports
    only the standard library and numpy at module level."""
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        smoke = {m.split(".")[0] for m in _imported_modules(
            ast.parse(fh.read()))}
    third_party = smoke - set(sys.stdlib_module_names)
    assert third_party == {"numpy", "torch", "floria_tpu_torch", "bench"}
    with open(os.path.join(REPO, "bench.py")) as fh:
        top = ast.parse(fh.read()).body
    bench = {m.split(".")[0] for node in top
             if isinstance(node, (ast.Import, ast.ImportFrom))
             for m in _imported_modules(node)}
    assert bench - set(sys.stdlib_module_names) == {"numpy"}


def test_chip_smoke_ecoli2_is_bench_config():
    import bench
    import chip_smoke

    cfg, tag = bench._e2e_config(False)
    assert tag == "ecoli2"
    want = dataclasses.asdict(cfg)
    assert {k: want[k] for k in chip_smoke.ECOLI2} == chip_smoke.ECOLI2
    from floria_tpu_torch.sim.simulate import SimConfig
    assert SimConfig(**chip_smoke.ECOLI2) == cfg
