"""The port stands alone: no module of `floria_tpu_torch` and no line of
chip_smoke.py imports jax or the JAX package `floria_tpu` (checked on
the sources, at any nesting level, and at run time, where the port's CLI
and its four host tools run end to end in a process that refuses both),
its copied host modules read and write what the reference's do, its
native library and its CUDA kernels build once under concurrent
processes, `--device cuda` without a card raises, and the multi-device
flags reach the mesh."""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "floria_tpu_torch")

# One intra-op thread: the suite runs several pytest workers on one
# host, and oversubscribed OpenMP threads slow every worker down.
torch.set_num_threads(1)

_REFUSE = r"""
import importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "floria_tpu"):
            raise ImportError(name + " is blocked in this process")
        return None

sys.meta_path.insert(0, Refuse())
sys.path.insert(0, {repo!r})
"""

_UNLOADED = r"""
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "floria_tpu"))
assert not loaded, loaded
"""

_CHILD = _REFUSE + r"""
from floria_tpu_torch.sim.simulate import SimConfig, simulate
simulate(SimConfig(contig_len=20_000, num_strains=2, num_snps=100,
                   coverage_per_strain=8.0, read_length=3_000,
                   read_length_sd=400.0, error_rate=0.01, seed=7),
         {sim!r})
from floria_tpu_torch import cli
cli.main(["-b", {sim!r} + "/sim.bam", "-v", {sim!r} + "/sim.vcf",
          "-r", {sim!r} + "/sim.fa", "-o", {out!r}, "--overwrite",
          "--device", "cpu", "-e", "0.02", "-l", "3000",
          "--snp-count-filter", "10"])
""" + _UNLOADED + r"""
print("JAXFREE_OK")
"""


def _py_sources():
    for d, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield "." * node.level + (node.module or "")


def _run(code, timeout=300, **kw):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=timeout,
                          **kw)


def test_no_jax_or_reference_import_in_sources():
    """Every `import`/`from ... import` of the port and of chip_smoke.py,
    at any nesting level (functions, try blocks, conditionals)."""
    bad = []
    for path in [*_py_sources(), os.path.join(REPO, "chip_smoke.py")]:
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for mod in _imported_modules(tree):
            if mod.split(".")[0] in ("jax", "jaxlib", "floria_tpu"):
                bad.append(f"{os.path.relpath(path, REPO)}: {mod}")
    assert not bad, bad


def test_cli_runs_with_jax_and_the_reference_blocked(tmp_path):
    code = _CHILD.format(repo=REPO, sim=str(tmp_path / "sim"),
                         out=str(tmp_path / "out"))
    proc = _run(code, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "JAXFREE_OK" in proc.stdout
    contig_dir = tmp_path / "out" / "sim_contig"
    assert (contig_dir / "sim_contig.vartigs").stat().st_size > 0


# The measurement scripts also import numpy and torch.
MEASUREMENT_SCRIPTS = ["mfu", "multihost_bench", "oracle_e2e_baseline",
                       "profile_beam", "scaling_bench"]


def test_scripts_import_only_the_port_and_the_standard_library():
    """The four host tools under floria_tpu_torch/scripts/ import the
    standard library and the port's own modules (relative imports that
    stay inside the package), nothing else: no jax, no `floria_tpu`,
    not even numpy directly; the measurement scripts beside them (the
    oracle's e2e baseline among them) add numpy and torch, nothing
    else."""
    root = os.path.join(PKG, "scripts")
    scripts = sorted(f[:-3] for f in os.listdir(root)
                     if f.endswith(".py") and f != "__init__.py")
    tools = ["get_bam_partition", "haplotag_bam", "haplotag_output_dir",
             "output_snpped_contigs"]
    assert scripts == sorted(tools + MEASUREMENT_SCRIPTS)
    for f in ["__init__"] + scripts:
        allowed = set(sys.stdlib_module_names)
        if f in MEASUREMENT_SCRIPTS:
            allowed |= {"numpy", "torch"}
        with open(os.path.join(root, f + ".py")) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level:
                # scripts/ lies one level below the package root.
                assert node.level <= 2, (f, node.module)
                continue
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     else [])
            for mod in names:
                assert mod.split(".")[0] in allowed, (f, mod)
        if f != "__init__":
            assert any(isinstance(n, ast.FunctionDef) and n.name == "main"
                       for n in tree.body), f


_TOOLS_CHILD = _REFUSE + r"""
import os, runpy
from floria_tpu_torch.ingest.bam import BamFile
from floria_tpu_torch.ingest.vcf import read_vcf
from floria_tpu_torch.sim.simulate import SimConfig, simulate
sim, out = {sim!r}, {out!r}
cfg = SimConfig(contig_len=12_000, num_strains=2, num_snps=60,
                coverage_per_strain=4.0, read_length=2_000,
                read_length_sd=300.0, error_rate=0.01, seed=9)
simulate(cfg, sim)
contig = cfg.contig_name
names = [r.qname for r in BamFile(sim + "/sim.bam").fetch(contig)]
os.makedirs(os.path.join(out, contig))
haplosets = os.path.join(out, contig, contig + ".haplosets")
with open(haplosets, "w") as fh:
    for k in range(2):
        fh.write(f">HAP{{k}}.x\tCONTIG:{{contig}}\tHAPQ:60\n")
        fh.writelines(f"{{n}}\t1\t9\n" for n in names[k::2])
cv = read_vcf(sim + "/sim.vcf", [contig]).get(contig)
vartigs = os.path.join(out, contig, contig + ".vartigs")
with open(vartigs, "w") as fh:
    fh.write(f">HAP0.x\tCONTIG:{{contig}}\tSNPRANGE:1-4\tBASERANGE:"
             f"{{cv.snp_to_gn(1) + 1}}-{{cv.snp_to_gn(4) + 1}}\n01?1\n")
for name, argv in (
        ("haplotag_bam", ["-t", haplosets, "-b", sim + "/sim.bam",
                          "-o", out + "/tagged", "-n", contig]),
        ("haplotag_output_dir", ["-d", out, "-b", sim + "/sim.bam",
                                 "-o", out + "/all"]),
        ("get_bam_partition", ["-t", haplosets, "-b", sim + "/sim.bam",
                               "-p", out + "/part-"]),
        ("output_snpped_contigs", ["-f", sim + "/sim.fa", "-v",
                                   sim + "/sim.vcf", "-o", out + "/c.fa",
                                   "-t", vartigs])):
    # As `python -m floria_tpu_torch.scripts.<name>` runs it.
    sys.argv = [name, *argv]
    runpy.run_module("floria_tpu_torch.scripts." + name,
                     run_name="__main__", alter_sys=True)
""" + _UNLOADED + r"""
print("JAXFREE_OK", sorted(f for f in os.listdir(out) if "." in f))
"""


def test_tools_run_with_jax_and_the_reference_blocked(tmp_path):
    """The four host tools, each run as its module's __main__, in a
    process that refuses jax and `floria_tpu`."""
    code = _TOOLS_CHILD.format(repo=REPO, sim=str(tmp_path / "sim"),
                               out=str(tmp_path / "out"))
    proc = _run(code, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    assert lines[-1] == ("JAXFREE_OK ['all.bam', 'c.fa', 'part-0.bam', "
                         "'part-1.bam', 'tagged.bam']")
    assert "Completed and written to output file" in lines
    c_fa = (tmp_path / "out" / "c.fa").read_text().splitlines()
    assert c_fa[0] == ">HAP0.x" and "N" in c_fa[1]


_INSTANCES_CHILD = _REFUSE + r"""
import numpy as np
from chip_smoke import workload_blocks
from floria_tpu_torch import native
from floria_tpu_torch.bench import make_workload
from floria_tpu_torch.kernels import beam, upem_batch
from floria_tpu_torch.options import Options
from floria_tpu_torch.parallel.mesh import pad_to_multiple
from floria_tpu_torch.phase import local
al, wt, nr, eps = make_workload(2, 24, 64)
res = beam.beam_search_batch(al, wt, nr, eps, 2, 4, device="cpu")
a0 = beam.traceback(tuple(x[0] for x in res), int(nr[0]), 2)
diff, score, mec = upem_batch.upem_eval_batch(al, wt, np.stack([a0, a0]),
                                              eps, 2, device="cpu")
best, mec = upem_batch.optimize_batch(al, wt, np.stack([a0, a0]), nr, eps,
                                      2, device="cpu")
gs = upem_batch._GroupState(al, wt, best, nr, eps, 2, device="cpu")
upem_batch.optimize_many([gs])
blocks = workload_blocks(2, 24, 64)
opts = Options(max_ploidy=3)
asg = local.phase_instances(blocks, opts, [2, 3], device="cpu")
ref, stats = local.refine_instances(blocks, asg, opts, device="cpu")
n = native.baseline_sweep(al, wt, [2, 3], 4, float(eps[0]))
packed = native.pack_windows(np.frombuffer(b"ACGT" * 64, np.uint8),
                             np.array([40, 80]), 16)
assert (pad_to_multiple(5, 4), len(asg), len(ref), n, packed.shape) == (
    8, 4, 6, 48, (2, 16)), (len(asg), len(ref), n)
""" + _UNLOADED + r"""
print("JAXFREE_OK")
"""


def test_instance_api_runs_with_jax_and_the_reference_blocked(tmp_path):
    """The instance API (beam_search_batch, traceback, upem_eval_batch,
    optimize_batch, optimize_many, phase_instances, refine_instances,
    native.baseline_sweep and pack_windows, pad_to_multiple) in a process
    that refuses jax and `floria_tpu`."""
    proc = _run(_INSTANCES_CHILD.format(repo=REPO), cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.splitlines()[-1] == "JAXFREE_OK"


_BENCH_CHILD = _REFUSE + r"""
import subprocess
from floria_tpu_torch import bench
from floria_tpu_torch.scripts import mfu, profile_beam, scaling_bench
args = bench.make_workload(2, 16, 32)
assert bench.measure_kernel(args, True, device="cpu") > 0
assert bench.measure_cpu_baseline(args, True)[0] > 0
mfu.main(["--model"])
scaling_bench.measure(2, 16, 32, [2], device="cpu")
profile_beam.run_case(4, 16, 32, 0, device="cpu")
for name in ("floria_tpu_torch.bench",
             "floria_tpu_torch.scripts.multihost_bench"):
    # Without a card the entry points raise and print nothing.
    proc = subprocess.run([sys.executable, "-m", name], cwd={repo!r},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and not proc.stdout, (name, proc.stdout)
    assert "is_available() is False" in proc.stderr, proc.stderr[-2000:]
""" + _UNLOADED + r"""
print("JAXFREE_OK")
"""


def test_bench_and_measurement_scripts_run_with_jax_and_the_reference_blocked(
        tmp_path):
    """floria_tpu_torch.bench's kernel and baseline measurements, mfu's
    model, scaling_bench and profile_beam on the CPU in a process that
    refuses jax and `floria_tpu`; `python -m` of the bench and of
    multihost_bench on a host without a card exits non-zero and prints
    nothing on stdout."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run(_BENCH_CHILD.format(repo=REPO), cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.splitlines()[-1] == "JAXFREE_OK"


_ORACLE_CHILD = _REFUSE + r"""
from floria_tpu_torch import oracle
from floria_tpu_torch.options import Options
from floria_tpu_torch.scripts import oracle_e2e_baseline
from floria_tpu_torch.sim.simulate import SimConfig, simulate
sim = {sim!r}
cfg = SimConfig(contig_len=12_000, num_strains=2, num_snps=60,
                coverage_per_strain=6.0, read_length=2_000,
                read_length_sd=300.0, error_rate=0.02, seed=21)
simulate(cfg, sim)
opts = Options(bam_file=sim + "/sim.bam", vcf_file=sim + "/sim.vcf",
               reference_fasta=sim + "/sim.fa", epsilon=0.02,
               block_length=3000, snp_count_filter=10)
for use_native in (True, False):
    texts, phased, _s = oracle.run_contig(opts, cfg.contig_name,
                                          device="cpu",
                                          use_native=use_native)
    assert phased[0] and texts["vartigs"], phased
line, windows = oracle_e2e_baseline.measure(sim, cfg.contig_name)
assert line["baseline_e2e_reads"] > 0 and len(windows) == 3, line
""" + _UNLOADED + r"""
print("JAXFREE_OK")
"""


def test_oracle_runs_with_jax_and_the_reference_blocked(tmp_path):
    """The port's oracle pipeline (`floria_tpu_torch.oracle`, native and
    Python beam) and its e2e script's measurement in a process that
    refuses jax and `floria_tpu`."""
    proc = _run(_ORACLE_CHILD.format(repo=REPO, sim=str(tmp_path / "sim")),
                cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.splitlines()[-1] == "JAXFREE_OK"


def _public_defs(root):
    """{module path: names of its top-level public functions and
    classes} of the package at `root`."""
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(d, f)
                with open(path) as fh:
                    tree = ast.parse(fh.read())
                out[os.path.relpath(path, root)] = {
                    n.name for n in tree.body
                    if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                    and not n.name.startswith("_")}
    return out


# What the port leaves out of the JAX package, each for the reason
# ROADMAP.md's queue 1 gives: the AOT blob cache, the Pallas kernel (K1
# is its port), the numpy oracles the JAX tests call, and the numpy /
# jnp pairs of the score functions (the port's binom_tail and
# log_sum_exp serve both). The port's timing records spans
# (`timing.span`), whose root clears STAGE_TIMES: it has no `add` or
# `reset`.
NOT_PORTED = {
    "aotcache.py": None, "kernels/beam_pallas.py": None,
    "kernels/stats.py": None, "kernels/upem.py": None,
    "kernels/scores.py": {"binom_tail_np", "binom_tail_jnp",
                          "log_sum_exp_np", "log_sum_exp_jnp"},
    "timing.py": {"add", "reset"},
}


def test_port_defines_every_public_function_of_the_reference():
    """Module by module and name by name, every top-level public function
    and class of `floria_tpu` has its namesake in the port, apart from
    NOT_PORTED."""
    ref = _public_defs(os.path.join(REPO, "floria_tpu"))
    port = _public_defs(PKG)
    missing = {}
    for mod, names in ref.items():
        if mod not in port:
            missing[mod] = None
        elif names - port[mod]:
            missing[mod] = names - port[mod]
    assert missing == NOT_PORTED


_IMPORT_ALL = r"""
import pkgutil, importlib, floria_tpu_torch
mods = [importlib.import_module(m.name) for m in pkgutil.walk_packages(
    floria_tpu_torch.__path__, "floria_tpu_torch.")]
"""


@pytest.mark.parametrize("first", ["port", "reference"])
def test_port_modules_hold_nothing_of_jax_or_the_reference(first):
    """Every port module imported into a fresh process. Imported first,
    the port loads neither jax nor `floria_tpu`, and jax still imports
    afterwards. Imported after both (an A/B process), the reference keeps
    its x64 configuration and no port module binds a jax or `floria_tpu`
    module, class or function."""
    pre = ("import jax, floria_tpu\n" if first == "reference" else "")
    post = (_UNLOADED + "import jax\n" if first == "port" else
            "assert jax.config.jax_enable_x64\n")
    code = ("import sys, types; sys.path.insert(0, %r)\n" % REPO + pre
            + _IMPORT_ALL + r"""
for m in mods:
    for name, v in vars(m).items():
        home = (v.__name__ if isinstance(v, types.ModuleType)
                else getattr(v, "__module__", None))
        if isinstance(home, str) and home.split(".")[0] in (
                "jax", "jaxlib", "floria_tpu"):
            raise AssertionError(f"{m.__name__}.{name} is from {home}")
""" + post + "print('OK', len(mods))\n")
    proc = _run(code, timeout=180)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("OK")
    assert int(proc.stdout.split()[1]) >= 40


def _sim_cfg(mod, seed=21):
    return mod.SimConfig(contig_len=12_000, num_strains=2, num_snps=60,
                         coverage_per_strain=6.0, read_length=2_000,
                         read_length_sd=300.0, error_rate=0.02, seed=seed)


@pytest.fixture(scope="module")
def both_sims(tmp_path_factory):
    """The same community simulated by the reference and by the port."""
    from floria_tpu.sim import simulate as ref_sim
    from floria_tpu_torch.sim import simulate as port_sim

    out = {}
    for tag, mod in (("reference", ref_sim), ("port", port_sim)):
        d = str(tmp_path_factory.mktemp("sim_" + tag))
        truth = mod.simulate(_sim_cfg(mod), d)
        out[tag] = (d, truth)
    return out


def _records(bam_mod, path):
    bam = bam_mod.BamFile(path)
    return [(r.qname, r.flag, r.tid, r.pos, r.mapq, list(r.cigar),
             r.seq.tobytes(), r.qual.tobytes(), r.tlen)
            for contig in bam.references for r in bam.fetch(contig)]


def _vcf(vcf_mod, path, contigs):
    prof = vcf_mod.read_vcf(path, contigs)
    return {c: (cv.genome_pos.tolist(), cv.pos_allele_map, cv.pos_to_snp,
                cv.allele_matrix().tolist())
            for c, cv in prof.contigs.items()}


@pytest.mark.parametrize("what", ["simulate", "bam", "vcf", "fasta"])
def test_copied_host_modules_match_the_reference(both_sims, what):
    """The port's copies of the simulator and of the BAM, VCF and FASTA
    readers, against the reference's on one seed: the same bytes and the
    same records."""
    from floria_tpu.ingest import bam as ref_bam
    from floria_tpu.ingest import fasta as ref_fasta
    from floria_tpu.ingest import vcf as ref_vcf
    from floria_tpu_torch.ingest import bam as port_bam
    from floria_tpu_torch.ingest import fasta as port_fasta
    from floria_tpu_torch.ingest import vcf as port_vcf

    (ref_dir, ref_truth), (port_dir, port_truth) = (both_sims["reference"],
                                                    both_sims["port"])
    if what == "simulate":
        for name in ("sim.bam", "sim.vcf", "sim.fa"):
            with open(os.path.join(ref_dir, name), "rb") as a, \
                    open(os.path.join(port_dir, name), "rb") as b:
                assert a.read() == b.read(), name
        for f in dataclasses.fields(ref_truth):
            a, b = getattr(ref_truth, f.name), getattr(port_truth, f.name)
            assert np.array_equal(np.asarray(a), np.asarray(b)), f.name
        return
    # The port's readers on the reference's files, and the reverse.
    if what == "bam":
        for d in (ref_dir, port_dir):
            path = os.path.join(d, "sim.bam")
            want = _records(ref_bam, path)
            assert want and _records(port_bam, path) == want
            assert (port_bam.get_contigs_to_phase(path)
                    == ref_bam.get_contigs_to_phase(path))
    elif what == "vcf":
        contigs = ref_bam.get_contigs_to_phase(
            os.path.join(ref_dir, "sim.bam"))
        for d in (ref_dir, port_dir):
            path = os.path.join(d, "sim.vcf")
            want = _vcf(ref_vcf, path, contigs)
            assert want and _vcf(port_vcf, path, contigs) == want
    else:
        for d in (ref_dir, port_dir):
            path = os.path.join(d, "sim.fa")
            ref_fa, port_fa = ref_fasta.FastaFile(path), \
                port_fasta.FastaFile(path)
            names = ref_fa.references()
            assert names and port_fa.references() == names
            for name in names:
                assert port_fa.fetch(name) == ref_fa.fetch(name)


_BUILD_CHILD = r"""
import sys
sys.path.insert(0, {repo!r})
from floria_tpu_torch import native
lib = native.build_and_load(sys.argv[1])
native._bind(lib)
print("LOADED", lib.floria_nw_batch is not None)
"""


def test_native_library_builds_once_under_six_concurrent_processes(
        tmp_path):
    """Six processes find the port's native library missing at once and
    build it into one empty directory: every one of them loads it, and
    no half-written temporary is left behind."""
    build = tmp_path / "build"
    code = _BUILD_CHILD.format(repo=REPO)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for _ in range(6)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
        assert out.strip() == "LOADED True", out
    assert sorted(os.listdir(build)) == ["libfloria_native.lock",
                                        "libfloria_native.so"]


def test_cuda_device_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from floria_tpu_torch import cli

    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["-b", "x.bam", "-v", "x.vcf", "-r", "x.fa",
                  "-o", str(tmp_path / "out"), "--device", "cuda"])


@pytest.mark.parametrize("flag,want", [([], 2), (["--num-devices", "5"], 2),
                                       (["--num-devices", "1"], 1)])
def test_num_devices_clamps_to_the_cards(flag, want, tmp_path,
                                         monkeypatch):
    """--num-devices above the card count clamps to the cards, as the
    JAX package clamps to its local devices; the default is all of
    them. (Two cards faked: the run itself is replaced.)"""
    from floria_tpu_torch import cli

    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(cli, "run", lambda options, *, device:
                        seen.append(device))
    cli.main(["-b", "x.bam", "-v", "x.vcf", "-r", "x.fa", "-e", "0.02",
              "-l", "3000", "-o", str(tmp_path / "out"), *flag])
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert seen == [cards if want == 2 else [torch.device("cuda")]]


def test_num_processes_without_coordinator_raises(tmp_path):
    from floria_tpu_torch import cli

    with pytest.raises(ValueError, match="--coordinator"):
        cli.main(["-b", "x.bam", "-v", "x.vcf", "-r", "x.fa",
                  "-o", str(tmp_path / "out"), "--device", "cpu",
                  "--num-processes", "2"])
    assert not (tmp_path / "out").exists()


_STUB_NVCC = r"""#!/bin/sh
# Stands in for nvcc: logs each call, waits, writes its -o file.
out=""
prev=""
for a in "$@"; do
  [ "$prev" = "-o" ] && out="$a"
  prev="$a"
done
case " $* " in
  *" -shared "*) echo "link $$" >> "$NVCC_LOG" ;;
  *) echo "compile $$" >> "$NVCC_LOG" ;;
esac
sleep 0.5
echo stub > "$out"
"""

_CUDA_BUILD_CHILD = r"""
import sys
sys.path.insert(0, {repo!r})
from floria_tpu_torch.kernels import _build
print("BUILT", _build.build(build_dir=sys.argv[1]) > 0)
"""


def test_cuda_build_runs_once_under_two_processes(tmp_path):
    """Two processes (the ranks of a multi-process run) find the kernel
    library missing at once: one compiles every source and links, the
    other waits on the lock and finds it current."""
    from floria_tpu_torch.kernels import _build

    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(_STUB_NVCC)
    nvcc.chmod(0o755)
    log = tmp_path / "nvcc.log"
    build = tmp_path / "build"
    env = dict(os.environ, NVCC_LOG=str(log),
               PATH=f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    code = _CUDA_BUILD_CHILD.format(repo=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (_out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    assert sorted(out.strip() for out, _err in outs) == ["BUILT False",
                                                          "BUILT True"]
    calls = log.read_text().split()[::2]
    assert calls.count("compile") == len(_build._sources()) >= 3
    assert calls.count("link") == 1
    assert sorted(os.listdir(build)) == ["libfloria_tpu_torch.lock",
                                        "libfloria_tpu_torch.so"]


def test_chip_smoke_imports_neither_jax_nor_the_reference():
    """chip_smoke.py reaches the simulator, stage timers, pipeline and
    bench.py's workload and measurements through the port's modules
    (`floria_tpu_torch.bench`, `scripts.multihost_bench`): its
    third-party imports are numpy, torch and the port."""
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        smoke = {m.split(".")[0] for m in _imported_modules(
            ast.parse(fh.read()))}
    third_party = smoke - set(sys.stdlib_module_names)
    assert third_party == {"numpy", "torch", "floria_tpu_torch"}


def test_chip_smoke_ecoli2_is_bench_config():
    """The e2e communities of floria_tpu_torch.bench (chip_smoke.py's
    `ecoli2` and the bench phase's) are bench.py's, field for field."""
    import bench
    from floria_tpu_torch import bench as port_bench

    for quick, tag in ((False, "ecoli2"), (True, "quick2")):
        want, want_tag = bench._e2e_config(quick)
        got, got_tag = port_bench._e2e_config(quick)
        assert got_tag == want_tag == tag
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_chip_smoke_sweep_workload_is_bench_workload():
    """chip_smoke.py's sweep workload is floria_tpu_torch.bench's
    make_workload, which equals bench.py's."""
    import bench
    import chip_smoke
    from floria_tpu_torch import bench as port_bench

    assert chip_smoke.make_workload is port_bench.make_workload
    for got, want in zip(chip_smoke.make_workload(3, 40, 256, seed=4),
                         bench.make_workload(3, 40, 256, seed=4)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_chip_smoke_multi_community_is_multihost_bench_config(
        tmp_path, monkeypatch):
    """The parallel phase's community (floria_tpu_torch.scripts.
    multihost_bench `build_sim`) is scripts/multihost_bench.py's
    (BASELINE.json config #5), contig for contig, at its default
    contig count."""
    from floria_tpu.sim import simulate as ref_sim
    from floria_tpu_torch.scripts import multihost_bench as port_mh
    from floria_tpu_torch.sim import simulate as port_sim

    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    import multihost_bench

    seen, port_seen = [], []
    monkeypatch.setattr(ref_sim, "simulate_multi",
                        lambda cfgs, base: seen.extend(cfgs))
    monkeypatch.setattr(port_sim, "simulate_multi",
                        lambda cfgs, base: port_seen.extend(cfgs))
    multihost_bench.build_sim(7, str(tmp_path))
    port_mh.build_sim(7, str(tmp_path))
    assert [dataclasses.asdict(c) for c in port_seen] \
        == [dataclasses.asdict(c) for c in seen]
    assert len(seen) == 7
    with open(multihost_bench.__file__) as fh:
        tree = ast.parse(fh.read())
    (default,) = [kw.value.value for node in ast.walk(tree)
                  if isinstance(node, ast.Call) and node.args
                  and isinstance(node.args[0], ast.Constant)
                  and node.args[0].value == "--contigs"
                  for kw in node.keywords if kw.arg == "default"]
    assert port_mh.CONTIGS == default == 500


def test_simulate_multi_and_sequence_packing_match_the_reference(
        tmp_path):
    """The port's simulate_multi (with its vectorized BAM sequence
    packing) writes the reference's bytes."""
    from floria_tpu.sim import bamwrite as ref_bw
    from floria_tpu.sim import simulate as ref_sim
    from floria_tpu_torch.sim import bamwrite as port_bw
    from floria_tpu_torch.sim import simulate as port_sim

    rng = np.random.default_rng(0)
    for n in range(40):
        for alphabet in (range(256), b"ACGTNacgtn=MRSVWYHKDB"):
            seq = bytes(rng.choice(list(alphabet), n).astype(np.uint8))
            assert port_bw._pack_seq(seq) == ref_bw._pack_seq(seq)
    from floria_tpu_torch.scripts.multihost_bench import multi_configs

    cfgs = multi_configs(2)
    ref_sim.simulate_multi([ref_sim.SimConfig(**dataclasses.asdict(c))
                            for c in cfgs], str(tmp_path / "ref"))
    port_sim.simulate_multi(cfgs, str(tmp_path / "port"))
    for name in ("sim.bam", "sim.vcf", "sim.fa"):
        assert (tmp_path / "ref" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes(), name
