"""The port's four host tools (floria_tpu_torch.scripts) against the JAX
package's scripts under scripts/ on the same inputs and argv: every
output file byte for byte and every stdout line, quirks included (the
HAPQ defaults, the ERROR line of a contig directory without a haploset,
the all-records fallback of a haploset named after a contig the BAM
lacks, '?' sites, allele indices past the alleles, allele strings longer
than their SNP range and a trailing odd vartig line).

Run as a script, it writes tests/data/scripts_golden.json, the JAX
scripts' outputs on long3 (chip_smoke.scripts_outputs through the JAX
scripts, on the JAX CLI's output), which chip_smoke.py's tools phase
holds the port's tools to on the card:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_scripts.py
"""

import contextlib
import io
import json
import os
import re
import runpy
import shutil
import struct
import sys
import tempfile

import pytest
import torch

import chip_smoke
from floria_tpu_torch import cli
from floria_tpu_torch.ingest.bam import BamFile
from floria_tpu_torch.ingest.vcf import read_vcf

# One intra-op thread: the suite runs several pytest workers on one
# host, and oversubscribed OpenMP threads slow every worker down.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_jax_script(name, argv):
    """scripts/<name>.py as its own `__main__` in this process, with
    `argv` as its arguments; sys.argv and sys.path (which the script
    extends) restored. Returns its stdout lines."""
    path = os.path.join(REPO, "scripts", name + ".py")
    saved_argv, saved_path = sys.argv, sys.path[:]
    sys.argv = [path, *argv]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = saved_argv
        sys.path[:] = saved_path
    return buf.getvalue().splitlines()


def _snapshot(root):
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _both(name, argv, dest):
    """The JAX script, then the port's tool, each into an emptied
    `dest` with the same argv. Asserts equal files and stdout; returns
    the port's ({file: bytes}, stdout lines)."""
    got = {}
    for side, run in (("jax", run_jax_script),
                      ("torch", chip_smoke.run_port_tool)):
        shutil.rmtree(dest, ignore_errors=True)
        os.makedirs(dest)
        lines = run(name, argv)
        got[side] = (_snapshot(dest), lines)
    assert sorted(got["torch"][0]) == sorted(got["jax"][0])
    for f, data in got["jax"][0].items():
        assert got["torch"][0][f] == data, f
    assert got["torch"][1] == got["jax"][1]
    return got["torch"]


@pytest.fixture(scope="module")
def run_dir(small_sim, tmp_path_factory):
    """The port's CLI (on the CPU) on the small_sim community."""
    _cfg, _truth, sim = small_sim
    out = str(tmp_path_factory.mktemp("scripts_run") / "out")
    cli.main(["-b", sim + "/sim.bam", "-v", sim + "/sim.vcf",
              "-r", sim + "/sim.fa", "-o", out, "--overwrite",
              "--device", "cpu", "-e", "0.02", "-l", "4000",
              "--snp-count-filter", "10"])
    return out


def _records(path, contig=None):
    bam = BamFile(path)
    return [r.raw for r in (bam.fetch(contig) if contig
                            else bam.iter_records())]


@pytest.mark.parametrize("hapq", [["-q", "0"], [], ["-q", "30"]],
                         ids=["q0", "default", "q30"])
def test_haplotag_bam_matches_jax_script(hapq, small_sim, run_dir,
                                         tmp_path):
    cfg, _truth, sim = small_sim
    contig = cfg.contig_name
    dest = str(tmp_path / "dest")
    files, lines = _both("haplotag_bam", [
        "-t", os.path.join(run_dir, contig, f"{contig}.haplosets"),
        "-b", sim + "/sim.bam", "-o", os.path.join(dest, "tagged"),
        "-n", contig, *hapq], dest)
    assert list(files) == ["tagged.bam"]
    assert lines == ["Done! HP:i tags are now added to "
                     + os.path.join(dest, "tagged.bam")]
    tagged = _records(os.path.join(dest, "tagged.bam"), contig)
    assert len(tagged) == len(_records(sim + "/sim.bam", contig))
    assert any(b"HPi" in r for r in tagged)


@pytest.mark.parametrize("hapq", [[], ["-q", "0"]], ids=["default", "q0"])
def test_haplotag_output_dir_matches_jax_script(hapq, small_sim, run_dir,
                                                tmp_path):
    """On a result directory that also holds a contig directory with no
    haploset (its ERROR line, then the run goes on) and a plain file at
    the top (skipped), its haploset's group HAP1 set to HAPQ 0: tagged
    at -q 0, left untagged at the default -q 1."""
    cfg, _truth, sim = small_sim
    result = str(tmp_path / "result")
    shutil.copytree(run_dir, result)
    haplosets = os.path.join(result, cfg.contig_name,
                             f"{cfg.contig_name}.haplosets")
    with open(haplosets) as fh:
        text = fh.read()
    head = next(ln for ln in text.splitlines() if ln.startswith(">HAP1."))
    with open(haplosets, "w") as fh:
        fh.write(text.replace(head, re.sub(r"HAPQ:\d+", "HAPQ:0", head)))
    os.makedirs(os.path.join(result, "a_contig_without_haplosets"))
    with open(os.path.join(result, "zz_plain_file"), "w") as fh:
        fh.write("not a contig\n")
    dest = str(tmp_path / "dest")
    files, lines = _both("haplotag_output_dir", [
        "-d", result, "-b", sim + "/sim.bam",
        "-o", os.path.join(dest, "all"), *hapq], dest)
    assert list(files) == ["all.bam"]
    assert lines == [
        "ERROR: no haploset file for contig a_contig_without_haplosets. "
        "Skipping ...",
        f"Tagging for contig {cfg.contig_name} ...",
        "Done! HP:i tags are now added to " + os.path.join(dest, "all.bam")]
    hp1 = b"HPi" + struct.pack("<i", 1)
    assert any(r.endswith(hp1) for r in _records(
        os.path.join(dest, "all.bam"))) == bool(hapq)


@pytest.mark.parametrize("name", ["contig", "absent"])
def test_get_bam_partition_matches_jax_script(name, small_sim, run_dir,
                                              tmp_path):
    """The run's haploset, plus a group HAP7 of a read the BAM lacks,
    named after the BAM's contig (that contig's records) and after a
    dotted contig the BAM lacks (every record of the BAM); one file per
    part, the empty part 7 included."""
    cfg, _truth, sim = small_sim
    contig = cfg.contig_name
    with open(os.path.join(run_dir, contig, f"{contig}.haplosets")) as fh:
        text = fh.read()
    haplosets = str(tmp_path / (f"{contig}.haplosets" if name == "contig"
                                else "not.in.the.bam.haplosets"))
    with open(haplosets, "w") as fh:
        fh.write(text + ">HAP7.x\tCONTIG:c\tHAPQ:60\nno_such_read\t1\t2\n")
    dest = str(tmp_path / "dest")
    files, lines = _both("get_bam_partition", [
        "-t", haplosets, "-b", sim + "/sim.bam",
        "-p", os.path.join(dest, "split-")], dest)
    assert lines == [f"Splitting bam file for {haplosets} with "
                     f"{sim}/sim.bam", "Splitting complete"]
    assert len(files) > 2 and "split-7.bam" in files
    parts = {f: _records(os.path.join(dest, f)) for f in files}
    assert parts.pop("split-7.bam") == []
    assert all(parts.values())
    assert not any(b"HPi" in r for recs in parts.values() for r in recs)


def _hand_vartigs(sim, contig):
    """Vartigs over the simulated contig: a '?' site, an allele index
    past the site's alleles, an allele string longer than its SNP range,
    a base range that leaves SNPs outside it, and a trailing odd
    line."""
    cv = read_vcf(sim + "/sim.vcf", [contig]).get(contig)
    gn = [cv.snp_to_gn(s) + 1 for s in range(1, 13)]   # 1-based
    head = "\tCOV:3.0\tERR:0.01\tHAPQ:30\tREL_ERR:1.0"
    return (f">HAP0.hand\tCONTIG:{contig}\tSNPRANGE:1-5\t"
            f"BASERANGE:{gn[0]}-{gn[4]}{head}\n0?91?\n"
            f">HAP1.hand\tCONTIG:{contig}\tSNPRANGE:3-6\t"
            f"BASERANGE:{gn[2] - 7}-{gn[5] + 9}{head}\n1010111\n"
            f">HAP2.hand\tCONTIG:{contig}\tSNPRANGE:6-12\t"
            f"BASERANGE:{gn[7]}-{gn[9]}{head}\n1111111\n"
            f">HAP3.hand\tCONTIG:{contig}\tSNPRANGE:1-2\t"
            f"BASERANGE:{gn[0]}-{gn[1]}{head}\n")


@pytest.mark.parametrize("vartigs", ["run", "hand"])
def test_output_snpped_contigs_matches_jax_script(vartigs, small_sim,
                                                  run_dir, tmp_path):
    cfg, _truth, sim = small_sim
    contig = cfg.contig_name
    if vartigs == "run":
        path = os.path.join(run_dir, contig, f"{contig}.vartigs")
    else:
        path = str(tmp_path / "hand.vartigs")
        with open(path, "w") as fh:
            fh.write(_hand_vartigs(sim, contig))
    dest = str(tmp_path / "dest")
    files, lines = _both("output_snpped_contigs", [
        "-f", sim + "/sim.fa", "-o", os.path.join(dest, "contigs.fa"),
        "-v", sim + "/sim.vcf", "-t", path], dest)
    assert lines == ["Completed and written to output file"]
    out = files["contigs.fa"].decode().splitlines()
    with open(path) as fh:
        n_headers = sum(1 for ln in fh if ln.startswith(">"))
    if vartigs == "run":
        assert len(out) == 2 * n_headers > 0
        assert out[0].startswith(">HAP0.")
    else:
        # The trailing header has no allele line and is dropped.
        assert len(out) == 2 * (n_headers - 1) == 6
        assert out[1][0] != "N" and out[1][-1] == "N"
        assert out[1].count("N") >= 2


def write_golden():
    """The JAX CLI on long3 (the golden record's config and flags, its
    inputs and outputs held to tests/data/north_star_golden.json), then
    the JAX scripts on its output through chip_smoke.scripts_outputs."""
    from floria_tpu import cli as jax_cli
    from floria_tpu.sim.simulate import SimConfig, simulate

    entry = chip_smoke.load_north_star()["configs"]["long3"]
    contig = entry["sim_config"]["contig_name"]
    with tempfile.TemporaryDirectory() as tmp:
        sim_dir = os.path.join(tmp, "long3")
        simulate(SimConfig(**entry["sim_config"]), sim_dir)
        for f, want in entry["inputs_sha256"].items():
            if chip_smoke._sha256(os.path.join(sim_dir, f)) != want:
                raise SystemExit(f"long3 {f} differs from the golden "
                                 "record's input; nothing written")
        out_dir = os.path.join(tmp, "long3_out")
        jax_cli.main(["-b", sim_dir + "/sim.bam", "-v", sim_dir + "/sim.vcf",
                      "-r", sim_dir + "/sim.fa", "-o", out_dir,
                      "--overwrite", *chip_smoke.case_args(entry, sim_dir)])
        chip_smoke.assert_golden_outputs("long3", out_dir,
                                         entry["outputs_sha256"])
        record = {"long3": chip_smoke.scripts_outputs(
            sim_dir, out_dir, contig, os.path.join(tmp, "scripts"),
            run=run_jax_script)}
    with open(chip_smoke.GOLDEN_SCRIPTS, "w") as fh:
        json.dump(record, fh, indent=1)
        fh.write("\n")
    print(f"wrote {chip_smoke.GOLDEN_SCRIPTS}", file=sys.stderr)


if __name__ == "__main__":
    write_golden()
