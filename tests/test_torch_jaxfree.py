"""The port stands alone: no module of `floria_tpu_torch` and no line of
chip_smoke.py imports jax or the JAX package `floria_tpu` (checked on
the sources, at any nesting level, and at run time, where the port's CLI
runs end to end in a process that refuses both), its copied host
modules read and write what the reference's do, its native library and
its CUDA kernels build once under concurrent processes, `--device cuda`
without a card raises, and the multi-device flags reach the mesh."""

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
    """chip_smoke.py reaches the simulator, stage timers and pipeline
    through the port's modules and keeps its own copy of bench.py's
    sweep workload: its third-party imports are numpy, torch and the
    port."""
    with open(os.path.join(REPO, "chip_smoke.py")) as fh:
        smoke = {m.split(".")[0] for m in _imported_modules(
            ast.parse(fh.read()))}
    third_party = smoke - set(sys.stdlib_module_names)
    assert third_party == {"numpy", "torch", "floria_tpu_torch"}


def test_chip_smoke_ecoli2_is_bench_config():
    import bench
    import chip_smoke

    cfg, tag = bench._e2e_config(False)
    assert tag == "ecoli2"
    want = dataclasses.asdict(cfg)
    assert {k: want[k] for k in chip_smoke.ECOLI2} == chip_smoke.ECOLI2
    from floria_tpu_torch.sim.simulate import SimConfig
    assert dataclasses.asdict(SimConfig(**chip_smoke.ECOLI2)) == want


def test_chip_smoke_sweep_workload_is_bench_workload():
    import bench
    import chip_smoke

    for got, want in zip(chip_smoke.make_workload(3, 40, 256, seed=4),
                         bench.make_workload(3, 40, 256, seed=4)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_chip_smoke_multi_community_is_multihost_bench_config(
        tmp_path, monkeypatch):
    """The parallel phase's community is scripts/multihost_bench.py's
    `build_sim` (BASELINE.json config #5), contig for contig."""
    import chip_smoke
    from floria_tpu.sim import simulate as ref_sim

    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    import multihost_bench

    seen = []
    monkeypatch.setattr(ref_sim, "simulate_multi",
                        lambda cfgs, base: seen.extend(cfgs))
    multihost_bench.build_sim(7, str(tmp_path))
    assert [dataclasses.asdict(c) for c in chip_smoke.multi_configs(7)] \
        == [dataclasses.asdict(c) for c in seen]


def test_simulate_multi_and_sequence_packing_match_the_reference(
        tmp_path):
    """The port's simulate_multi (with its vectorized BAM sequence
    packing) writes the reference's bytes."""
    import chip_smoke
    from floria_tpu.sim import bamwrite as ref_bw
    from floria_tpu.sim import simulate as ref_sim
    from floria_tpu_torch.sim import bamwrite as port_bw
    from floria_tpu_torch.sim import simulate as port_sim

    rng = np.random.default_rng(0)
    for n in range(40):
        for alphabet in (range(256), b"ACGTNacgtn=MRSVWYHKDB"):
            seq = bytes(rng.choice(list(alphabet), n).astype(np.uint8))
            assert port_bw._pack_seq(seq) == ref_bw._pack_seq(seq)
    cfgs = chip_smoke.multi_configs(2)
    ref_sim.simulate_multi([ref_sim.SimConfig(**dataclasses.asdict(c))
                            for c in cfgs], str(tmp_path / "ref"))
    port_sim.simulate_multi(cfgs, str(tmp_path / "port"))
    for name in ("sim.bam", "sim.vcf", "sim.fa"):
        assert (tmp_path / "ref" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes(), name
