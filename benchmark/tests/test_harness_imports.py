"""Nothing of JAX or of the JAX package in a run, and nothing of the
program in the reference."""

import ast
import os
import subprocess
import sys

from conftest import BENCH, ROOT

from harness.checks import forbidden_modules


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_import_check_compares_whole_top_level_names():
    assert forbidden_modules(["floria_tpu_torch", "floria_tpu_torch.cli",
                              "jaxtyping", "flaxen", "numpy"]) == []
    assert forbidden_modules(["floria_tpu.cli", "jax", "jaxlib.xla",
                              "flax.linen", "floria_tpu_torch"]) == [
        "flax.linen", "floria_tpu.cli", "jax", "jaxlib.xla"]


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            for mod in _imports(os.path.join(ref, name)):
                top = mod.split(".")[0]
                assert top not in ("floria_tpu_torch", "floria_tpu", "jax",
                                   "jaxlib", "flax", "torch"), (name, mod)


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "import reference.cli, reference.phasing, reference.pipeline; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('floria_tpu_torch', 'floria_tpu', 'jax', 'torch')]; "
            "print(bad); sys.exit(1 if bad else 0)" % (BENCH, ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_harness_names_no_jax():
    for dirpath, _dirs, files in os.walk(BENCH):
        if "cache" in dirpath:
            continue
        for name in files:
            if name.endswith(".py") and not name.startswith("test_"):
                for mod in _imports(os.path.join(dirpath, name)):
                    assert mod.split(".")[0] not in (
                        "jax", "jaxlib", "flax", "floria_tpu"), (name, mod)
