"""The port's tools against the JAX package's on the same inputs:
vartig-dump, `get_frags_from_bam`, the legacy frags.txt reader and
writer, haplotagging, the evaluation against the simulated truth and the
simulator's CLI. Outputs byte-equal, values equal. Also runs
chip_smoke.py's `tools` phase on the CPU against the golden record
(tests/data/north_star_golden.json)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import chip_smoke
from floria_tpu import vartig_dump as jax_vartig_dump
from floria_tpu.frag import Frag as JaxFrag
from floria_tpu.ingest import fragfile as jax_fragfile
from floria_tpu.ingest.bam import BamFile as JaxBamFile
from floria_tpu.ingest.fasta import FastaFile as JaxFastaFile
from floria_tpu.ingest.fragments import get_frags_from_bam as jax_get_frags
from floria_tpu.ingest.vcf import read_vcf as jax_read_vcf
from floria_tpu.options import Options as JaxOptions
from floria_tpu.out import haplotag as jax_haplotag
from floria_tpu.pipeline import open_bam as jax_open_bam
from floria_tpu.sim import __main__ as jax_sim_cli
from floria_tpu.sim import evaluate as jax_evaluate
from floria_tpu_torch import cli
from floria_tpu_torch import vartig_dump as torch_vartig_dump
from floria_tpu_torch.frag import Frag as TorchFrag
from floria_tpu_torch.ingest import fragfile as torch_fragfile
from floria_tpu_torch.ingest.bam import BamFile as TorchBamFile
from floria_tpu_torch.ingest.fasta import FastaFile as TorchFastaFile
from floria_tpu_torch.ingest.fragments import \
    get_frags_from_bam as torch_get_frags
from floria_tpu_torch.ingest.vcf import read_vcf as torch_read_vcf
from floria_tpu_torch.options import Options as TorchOptions
from floria_tpu_torch.out import haplotag as torch_haplotag
from floria_tpu_torch.pipeline import open_bam as torch_open_bam
from floria_tpu_torch.sim import __main__ as torch_sim_cli
from floria_tpu_torch.sim import evaluate as torch_evaluate
from floria_tpu_torch.sim.simulate import SimTruth as TorchSimTruth

# One intra-op thread: the suite runs several pytest workers on one
# host, and oversubscribed OpenMP threads slow every worker down.
torch.set_num_threads(1)

FRAG_FIELDS = ("id", "counter_id", "is_paired", "first_position",
               "last_position", "first_pos_base", "last_pos_base",
               "seq_dict", "qual_dict", "snp_pos_to_seq_pos", "seq_string",
               "qual_string")


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def _frag_values(frags):
    return [tuple(getattr(f, k) for k in FRAG_FIELDS) for f in frags]


@pytest.fixture(scope="module")
def small_run(small_sim, tmp_path_factory):
    """The port's CLI (on the CPU) on the small_sim community: its
    vartigs and haplosets, which the CPU tests of the pipeline hold to
    the JAX package's bytes."""
    cfg, truth, sim = small_sim
    out = str(tmp_path_factory.mktemp("small_run") / "out")
    cli.main(["-b", sim + "/sim.bam", "-v", sim + "/sim.vcf",
              "-r", sim + "/sim.fa", "-o", out, "--overwrite",
              "--device", "cpu", "-e", "0.02", "-l", "4000",
              "--snp-count-filter", "10"])
    cdir = os.path.join(out, cfg.contig_name)
    return (os.path.join(cdir, f"{cfg.contig_name}.vartigs"),
            os.path.join(cdir, f"{cfg.contig_name}.haplosets"))


def test_vartig_dump_matches_jax(small_sim, tmp_path):
    cfg, _truth, sim = small_sim
    dest = str(tmp_path / "dump_vartigs.txt")
    out = {}
    for side, mod in (("jax", jax_vartig_dump), ("torch", torch_vartig_dump)):
        mod.main(["-b", sim + "/sim.bam", "-v", sim + "/sim.vcf",
                  "-o", dest])
        out[side] = _read(dest)
        os.remove(dest)
    assert out["torch"] == out["jax"]
    assert f"SNPRANGE:1-{cfg.num_snps}".encode() in out["torch"]


@pytest.mark.parametrize("reader", ["BamFile", "open_bam"])
@pytest.mark.parametrize("realign", [False, True])
def test_get_frags_from_bam_matches_jax(small_sim, reader, realign):
    """Both fragment lists (with and without SNPs), in the same order,
    field by field; with the FASTA the port realigns on the CPU, without
    it the port is given no device at all."""
    cfg, _truth, sim = small_sim
    contig = cfg.contig_name
    got = {}
    for side, bam_cls, open_fn, read_vcf, fasta, opts in (
            ("jax", JaxBamFile, jax_open_bam, jax_read_vcf, JaxFastaFile,
             JaxOptions()),
            ("torch", TorchBamFile, torch_open_bam, torch_read_vcf,
             TorchFastaFile, TorchOptions())):
        bam = (bam_cls if reader == "BamFile" else open_fn)(sim + "/sim.bam")
        cv = read_vcf(sim + "/sim.vcf", [contig]).get(contig)
        ref = fasta(sim + "/sim.fa").fetch(contig) if realign else None
        args = (bam, None, cv, opts, ref, contig)
        got[side] = (jax_get_frags(*args) if side == "jax" else
                     torch_get_frags(*args,
                                     device="cpu" if realign else None))
    for jax_list, torch_list in zip(got["jax"], got["torch"]):
        assert _frag_values(torch_list) == _frag_values(jax_list)
    assert got["torch"][0]


def _hand_frags(cls):
    """test_tools.py's fragment (two blocks, one gap) and one with a
    quality above 222, which the writer stores unshifted."""
    f1 = cls("r1", 0, False)
    for snp, allele, q in [(3, 1, 30), (4, 0, 20), (7, 1, 25)]:
        f1.add_site(snp, allele, q, 0, 0)
    f2 = cls("r2", 1, False)
    for snp, allele, q in [(1, 0, 230), (2, 1, 0), (3, 1, 40)]:
        f2.add_site(snp, allele, q, 0, 0)
    return [f1, f2]


@pytest.mark.parametrize("source", ["hand", "small_sim"])
def test_frags_file_matches_jax(source, small_sim, tmp_path):
    """write_frags_file byte-equal; read_frags_file equal values."""
    cfg, _truth, sim = small_sim
    if source == "hand":
        frags = {"jax": _hand_frags(JaxFrag), "torch": _hand_frags(TorchFrag)}
    else:
        contig = cfg.contig_name
        cv = torch_read_vcf(sim + "/sim.vcf", [contig]).get(contig)
        ref = TorchFastaFile(sim + "/sim.fa").fetch(contig)
        frags, _ = torch_get_frags(torch_open_bam(sim + "/sim.bam"), None,
                                   cv, TorchOptions(), ref, contig,
                                   device="cpu")
        frags = {"jax": frags, "torch": frags}
    written, back = {}, {}
    for side, mod in (("jax", jax_fragfile), ("torch", torch_fragfile)):
        path = str(tmp_path / f"{side}.frags.txt")
        mod.write_frags_file(frags[side], path)
        written[side] = _read(path)
        back[side] = mod.read_frags_file(path)
    assert written["torch"] == written["jax"]
    assert list(back["torch"]) == list(back["jax"]) == ["frag_contig"]
    assert _frag_values(back["torch"]["frag_contig"]) == \
        _frag_values(back["jax"]["frag_contig"])
    read = [(f.seq_dict, f.qual_dict) for f in back["torch"]["frag_contig"]]
    if source == "hand":
        assert read == [({3: 1, 4: 0, 7: 1}, {3: 30, 4: 20, 7: 25}),
                        ({1: 0, 2: 1, 3: 1}, {1: 230 - 33, 2: 0, 3: 40})]
    else:
        assert read == [(dict(f.seq_dict), dict(f.qual_dict))
                        for f in frags["torch"]]


@pytest.mark.parametrize("min_hapq", [0, 15, 30, 60])
def test_haplotag_matches_jax(min_hapq, small_sim, small_run, tmp_path):
    """read_haploset equal; the haplotagged BAM (haplotag_records, then
    write_bam_records) byte-equal; tagged records carry HP:i."""
    cfg, _truth, sim = small_sim
    _vartigs, haplosets = small_run
    out = {}
    for side, mod, bam_cls in (("jax", jax_haplotag, JaxBamFile),
                               ("torch", torch_haplotag, TorchBamFile)):
        parts = mod.read_haploset(haplosets, min_hapq)
        name_to_part = {n: i for i, names in parts.items() for n in names}
        bam = bam_cls(sim + "/sim.bam")
        records = mod.haplotag_records(bam, cfg.contig_name, name_to_part)
        path = str(tmp_path / f"{side}.bam")
        mod.write_bam_records(path, bam, records)
        out[side] = (parts, _read(path), name_to_part)
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][1] == out["jax"][1]
    tagged = TorchBamFile(str(tmp_path / "torch.bam")).fetch(cfg.contig_name)
    names = out["torch"][2]
    assert len(tagged) == len(TorchBamFile(sim + "/sim.bam").fetch(
        cfg.contig_name))
    assert all((b"HPi" in r.raw) == (r.qname in names) for r in tagged)
    if min_hapq == 0:
        assert names


_VARTIGS = (
    ">HAP0.x\tCONTIG:c\tSNPRANGE:1-5\tBASERANGE:1-401\tCOV:3.0\t"
    "ERR:0.01\tHAPQ:30\tREL_ERR:1.0\n00000\n"
    ">HAP1.x\tCONTIG:c\tSNPRANGE:6-10\tBASERANGE:501-901\tCOV:3.0\t"
    "ERR:0.01\tHAPQ:30\tREL_ERR:1.0\n111?0\n")
_HAPLOSETS = (">HAP0.x\theader\nr0\t1\t5\nr1\t1\t5\n"
              ">HAP1.x\theader\nr2\t6\t9\nr3\t6\t9\n")
# Groups of 4, 3 and 3 reads of mixed strains: N50 3, purity 0.7.
_HAPLOSETS_MIXED = (">HAP0.x\th\nr0\t1\t5\nr1\t1\t5\nr2\t1\t5\nr4\t1\t5\n"
                    ">HAP1.x\th\nr3\t6\t9\nr5\t6\t9\nr6\t6\t9\n"
                    ">HAP2.x\th\nr7\t2\t9\nr8\t2\t9\nr9\t2\t9\n")
# All-'?' vartigs and one-read haplosets: the evaluations' empty results.
_VARTIGS_EMPTY = (">HAP0.x\tCONTIG:c\tSNPRANGE:2-4\tBASERANGE:101-301\n"
                  "???\n")
_HAPLOSETS_EMPTY = ">HAP0.x\theader\nr0\t1\t5\n>HAP1.x\theader\nzz\t1\t2\n"


def _test_evaluate_truth():
    return dict(snp_positions=np.arange(10) * 100,
                strain_alleles=np.array([[0] * 10, [1] * 10]),
                read_strains={"r0": 0, "r1": 0, "r2": 1, "r3": 1, "r4": 0,
                              "r5": 1, "r6": 0, "r7": 0, "r8": 1, "r9": 1})


@pytest.mark.parametrize("case", ["test_evaluate", "mixed", "empty",
                                  "small_sim"])
def test_evaluate_matches_jax(case, small_sim, small_run, tmp_path):
    """evaluate_vartigs / evaluate_haplosets (and the parsers) give
    equal dataclasses on test_evaluate.py's cases, on degenerate files
    and on small_sim's real outputs."""
    if case == "small_sim":
        _cfg, truth, _sim = small_sim
        fields = dataclasses.asdict(truth)
        vartigs, haplosets = small_run
    else:
        fields = _test_evaluate_truth()
        vartigs = tmp_path / "v.vartigs"
        haplosets = tmp_path / "h.haplosets"
        empty = case == "empty"
        vartigs.write_text(_VARTIGS_EMPTY if empty else _VARTIGS)
        haplosets.write_text({"test_evaluate": _HAPLOSETS,
                              "mixed": _HAPLOSETS_MIXED,
                              "empty": _HAPLOSETS_EMPTY}[case])
        vartigs, haplosets = str(vartigs), str(haplosets)
    got = {}
    for side, mod, truth_cls in (
            ("jax", jax_evaluate, type(small_sim[1])),
            ("torch", torch_evaluate, TorchSimTruth)):
        truth = truth_cls(**fields)
        got[side] = (dataclasses.asdict(mod.evaluate_vartigs(vartigs, truth)),
                     dataclasses.asdict(mod.evaluate_haplosets(haplosets,
                                                               truth)),
                     mod.parse_vartigs(vartigs), mod.parse_haplosets(haplosets))
    assert got["torch"] == got["jax"]
    if case == "test_evaluate":
        assert got["torch"][0]["weighted_accuracy"] == (5 + 4 * 0.75) / 9
        assert got["torch"][1]["weighted_purity"] == 1.0
    elif case == "mixed":
        assert got["torch"][1] == {"num_groups": 3, "weighted_purity": 0.7,
                                   "n50_reads": 3}
    elif case == "empty":
        assert got["torch"][:2] == ({"num_vartigs": 0,
                                     "weighted_accuracy": 0.0,
                                     "total_span": 0,
                                     "covered_fraction": 0.0},
                                    {"num_groups": 0, "weighted_purity": 0.0,
                                     "n50_reads": 0})
    else:
        assert got["torch"][0]["num_vartigs"] > 0
        assert got["torch"][1]["num_groups"] > 0


@pytest.mark.parametrize("flags", [
    ["--strains", "2", "--length", "12000", "--snps", "60",
     "--coverage", "4", "--read-length", "2000"],
    ["--paired", "--length", "6000", "--coverage", "5", "--read-length",
     "150", "--error-rate", "0.01", "--seed", "3", "--contig-name", "ctg"],
], ids=["long", "paired"])
def test_sim_cli_matches_jax(flags, tmp_path, capsys):
    out = {}
    for side, mod in (("jax", jax_sim_cli), ("torch", torch_sim_cli)):
        dest = str(tmp_path / side)
        mod.main(["-o", dest, *flags])
        out[side] = ([_read(os.path.join(dest, f))
                      for f in ("sim.bam", "sim.vcf", "sim.fa")],
                     capsys.readouterr().out.replace(dest, "<dir>"))
    assert out["torch"] == out["jax"]


def test_smoke_tools_phase_on_the_cpu(tmp_path):
    """chip_smoke.py's long3 run, tools phase and sweep counter on the
    CPU: the port's CLI on long3 writes the JAX CLI's bytes (the golden
    record's hashes), the tools' outputs hash to the JAX tools', and the
    counter sees every sweep level and one climb per beam dispatch."""
    entry = chip_smoke.load_north_star()["configs"]["long3"]
    with chip_smoke.SweepCounter() as counter:
        rec, sim_dir, out_dir, _truth = chip_smoke.run_golden_case(
            "long3", entry, str(tmp_path), device="cpu")
    assert rec["files_equal_to_jax"] == len(entry["outputs_sha256"])
    summary = counter.summary()
    assert summary["highest_level"] >= 2
    assert summary["climbs"] == sum(summary["dispatches_by_level"]
                                    .values())
    chip_smoke.tools_phase(str(tmp_path), sim_dir, out_dir, device="cpu")
