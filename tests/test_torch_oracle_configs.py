"""The round's done-condition on the CPU: the port's pipeline
(`floria_tpu_torch.pipeline.run(opts, device="cpu")`) writes the JAX
package's bytes (`floria_tpu.pipeline.run(opts)`) on every config of
tests/test_pipeline_oracle.py and every seed of
tests/test_pipeline_fuzz.py. This file runs `supp2` and the hybrid
config; tests/test_torch_fuzz_a.py and _b.py run the fuzz seeds through
`run_both`, and tests/test_torch_pipeline.py runs `long2` and `paired2`.

tests/data/north_star_golden.json holds, for those configs and for
BASELINE.json config #4 (the 5-strain community, `config4`): the
SimConfig, the sha256 of the simulated inputs, the CLI flags that give
the case's Options, and the sha256 of every output file of the JAX CLI
(the run's -o written as "<out>"); for `config4` also the evaluation
against the simulated truth, and under "tools" the JAX tools' outputs on
`long3`. chip_smoke.py holds the port on the card to it. Every case here
also holds its JAX bytes to it. Regenerate it (~11 min: the JAX CLI on
every config, and on `config4` also the port's `--device cpu` CLI, which
must write the same bytes or nothing is written) with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_oracle_configs.py
"""

import dataclasses
import filecmp
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import pytest
import torch

import chip_smoke
from floria_tpu import cli as jax_cli
from floria_tpu.constants import CONTIG_PLOIDY_HEADER
from floria_tpu.options import Options as JaxOptions
from floria_tpu.pipeline import run as run_jax
from floria_tpu.sim.simulate import SimConfig
from floria_tpu_torch import cli as torch_cli
from floria_tpu_torch.options import Options as TorchOptions
from floria_tpu_torch.pipeline import run as run_torch
from test_pipeline_fuzz import _draw_config
from test_pipeline_oracle import CONFIGS

# One intra-op thread: the suite runs several pytest workers on one
# host, and oversubscribed OpenMP threads slow every worker down.
torch.set_num_threads(1)

FUZZ_SEEDS = (0, 1, 2, 3, 4, 5, 19)
# test_pipeline_oracle.py's hybrid config (test_pipeline_matches_oracle_hybrid).
HYBRID = SimConfig(contig_len=24_000, num_strains=2, num_snps=140,
                   coverage_per_strain=10.0, read_length=4_000,
                   read_length_sd=600.0, error_rate=0.02, seed=51)
HYBRID_SHORT_COVERAGE = 12.0
# BASELINE.json config #4: the 5-strain community (300 kbp, 9k SNPs,
# `-p 6 -s 3`, VALIDATION.md "5-strain"); the sim CLI's other defaults.
CONFIG4 = SimConfig(contig_len=300_000, num_strains=5, num_snps=9_000,
                    coverage_per_strain=12.0, read_length=8_000,
                    read_length_sd=1_500.0, error_rate=0.02, seed=7)
SMALL = (["long2", "long3", "paired2", "supp2", "hybrid"]
         + [f"fuzz{s}" for s in FUZZ_SEEDS])
ORACLE_FIELDS = dict(epsilon=0.02, block_length=4000, snp_count_filter=10)
SIM_MARK = chip_smoke.SIM_MARK


def fuzz_draws(seed):
    """test_pipeline_fuzz.py's Options draws for `seed`, draw for draw."""
    orng = np.random.default_rng(seed + 100)
    return dict(
        epsilon=float(orng.uniform(0.015, 0.03)),
        block_length=int(np.random.default_rng(seed + 200).integers(
            3_000, 5_000)),
        max_ploidy=int(orng.integers(3, 6)),
        max_number_solns=int(orng.integers(5, 17)),
        ploidy_sensitivity=int(orng.integers(1, 4)),
        stopping_heuristic=bool(orng.random() > 0.15),
        snp_count_filter=10)


def case(name):
    """(SimConfig, short-read coverage per strain or None, the Options
    fields besides paths and overwrite)."""
    if name in CONFIGS:
        return CONFIGS[name], None, dict(ORACLE_FIELDS)
    if name == "hybrid":
        return HYBRID, HYBRID_SHORT_COVERAGE, dict(
            ORACLE_FIELDS, hybrid=True, reassign_short=True)
    if name == "config4":  # -e and -l estimated from the BAM
        return CONFIG4, None, dict(max_ploidy=6, ploidy_sensitivity=3)
    seed = int(name[len("fuzz"):])
    return _draw_config(seed), None, fuzz_draws(seed)


def cli_args(fields):
    """The CLI flags (besides -b/-v/-r/-o/--overwrite) that give the
    Options `fields`; SIM_MARK stands for the inputs' directory."""
    flags = (("epsilon", "-e"), ("block_length", "-l"),
             ("max_ploidy", "-p"), ("max_number_solns", "-n"),
             ("ploidy_sensitivity", "-s"),
             ("snp_count_filter", "--snp-count-filter"))
    args = []
    for key, flag in flags:
        if key in fields:
            args += [flag, repr(fields[key])]
    if fields.get("stopping_heuristic") is False:
        args.append("--no-stop-heuristic")
    if fields.get("hybrid"):
        args += ["-H", f"{SIM_MARK}/sim_short.bam"]
    if fields.get("reassign_short"):
        args.append("--reassign-short")
    return args


def cli_argv(sim_dir, out_dir, args):
    """The CLI's whole argv for a case's flags `args`, inputs in
    `sim_dir`, output at `out_dir`."""
    return ["-b", os.path.join(sim_dir, "sim.bam"),
            "-v", os.path.join(sim_dir, "sim.vcf"),
            "-r", os.path.join(sim_dir, "sim.fa"), "-o", out_dir,
            "--overwrite", *[a.replace(SIM_MARK, sim_dir) for a in args]]


def case_options(name, sim_dir, out_dir, cls, **extra):
    _cfg, short, fields = case(name)
    return cls(bam_file=os.path.join(sim_dir, "sim.bam"),
               vcf_file=os.path.join(sim_dir, "sim.vcf"),
               reference_fasta=os.path.join(sim_dir, "sim.fa"),
               short_bam_file=(os.path.join(sim_dir, "sim_short.bam")
                               if short is not None else ""),
               out_dir=out_dir, overwrite=True, **fields, **extra)


def load_golden():
    with open(chip_smoke.GOLDEN_NORTH_STAR) as fh:
        return json.load(fh)


def first_difference(a, b):
    """The first line at which files `a` and `b` differ, for a message."""
    with open(a, "rb") as fa, open(b, "rb") as fb:
        la, lb = fa.read().splitlines(), fb.read().splitlines()
    for i, (x, y) in enumerate(zip(la, lb)):
        if x != y:
            return f"line {i + 1}: {x[:200]!r} != {y[:200]!r}"
    return f"{len(la)} lines against {len(lb)}"


def run_both(name, tmp_path, device="cpu", port_cli=False):
    """The JAX pipeline and the port's (its `run` on `device`, or with
    `port_cli` its CLI with the golden record's flags) on `name` at one
    -o, one after the other, each in a directory prepared as the CLI
    prepares it (the summary TSV's header): every output file but
    cmd.log byte-equal, and the JAX bytes equal to the golden record's
    hashes."""
    entry = load_golden()["configs"][name]
    cfg, _short, _fields = case(name)
    assert entry["sim_config"] == dataclasses.asdict(cfg)
    sim_dir = str(tmp_path / "sim")
    chip_smoke.simulate_case(entry, sim_dir)
    out_dir = str(tmp_path / "out")
    trees = {}
    for side in ("jax", "torch"):
        if side == "jax" or not port_cli:
            os.makedirs(out_dir)
            with open(os.path.join(out_dir, "contig_ploidy_info.tsv"),
                      "w") as fh:
                fh.write(CONTIG_PLOIDY_HEADER)
        if side == "jax":
            run_jax(case_options(name, sim_dir, out_dir, JaxOptions))
        elif port_cli:
            chip_smoke.run_cli(sim_dir, out_dir, device=device,
                               extra=chip_smoke.case_args(entry, sim_dir))
        else:
            run_torch(case_options(name, sim_dir, out_dir, TorchOptions),
                      device=device)
        trees[side] = str(tmp_path / side)
        shutil.move(out_dir, trees[side])
    files = chip_smoke._tree(trees["jax"])
    assert files == chip_smoke._tree(trees["torch"])
    assert any(f.endswith(".vartigs") for f in files)
    for f in files:
        a, b = (os.path.join(trees[s], f) for s in ("jax", "torch"))
        assert filecmp.cmp(a, b, shallow=False), \
            f"{name}: {f} {first_difference(a, b)}"
    assert chip_smoke.output_sha256(trees["jax"], out_dir) == \
        entry["outputs_sha256"]


@pytest.mark.parametrize("name", ["supp2", "hybrid"])
def test_north_star_config_matches_jax(name, tmp_path):
    run_both(name, tmp_path)


@pytest.mark.parametrize("name", ["long2", "paired2"])
def test_port_cli_matches_golden(name, tmp_path):
    """chip_smoke.py's north_star case on the CPU: the port's CLI with
    the golden record's flags writes the JAX CLI's bytes (the configs
    tests/test_torch_pipeline.py runs through `run`)."""
    entry = load_golden()["configs"][name]
    rec = chip_smoke.run_golden_case(name, entry, str(tmp_path),
                                     device="cpu")[0]
    assert rec["files_equal_to_jax"] == len(entry["outputs_sha256"]) > 0


@pytest.mark.parametrize("name", SMALL + ["config4"])
def test_golden_cli_args_give_the_case_options(name, tmp_path,
                                               monkeypatch):
    """The golden record's flags through the port's parser and
    options_from_args (and the JAX CLI's) give the Options the CPU case
    runs, field for field (the CLI's default -t is Options' default).
    For config4 the -e/-l estimate is the golden record's."""
    entry = load_golden()["configs"][name]
    assert entry["cli_args"] == cli_args(case(name)[2])
    auto = entry.get("auto_detect")
    extra = {}
    if auto is not None:
        est = (auto["block_length"], auto["epsilon"])
        extra = dict(epsilon=auto["epsilon"],
                     block_length=auto["block_length"])
        for mod in ("floria_tpu.ingest.autodetect",
                    "floria_tpu_torch.ingest.autodetect"):
            monkeypatch.setattr(f"{mod}.l_epsilon_auto_detect",
                                lambda _bam: est)
    sim_dir = str(tmp_path / "sim")
    got = {}
    for side, cli in (("jax", jax_cli), ("torch", torch_cli)):
        argv = cli_argv(sim_dir, str(tmp_path / side), entry["cli_args"])
        got[side] = cli.options_from_args(cli.build_parser().parse_args(
            argv))
    want = dataclasses.asdict(case_options(
        name, sim_dir, str(tmp_path / "torch"), TorchOptions, **extra))
    assert dataclasses.asdict(got["torch"]) == want
    assert dataclasses.asdict(got["jax"]) == dict(
        want, out_dir=str(tmp_path / "jax"))


def jax_tools_outputs(sim_dir, haplosets, contig, dest):
    """chip_smoke.tools_outputs through the JAX package's functions."""
    from floria_tpu import vartig_dump
    from floria_tpu.ingest.bam import BamFile
    from floria_tpu.ingest.fasta import FastaFile
    from floria_tpu.ingest.fragfile import read_frags_file, write_frags_file
    from floria_tpu.ingest.fragments import get_frags_from_bam
    from floria_tpu.ingest.vcf import read_vcf
    from floria_tpu.out.haplotag import (haplotag_records, read_haploset,
                                         write_bam_records)
    from floria_tpu.pipeline import open_bam

    bam, vcf = (os.path.join(sim_dir, f) for f in ("sim.bam", "sim.vcf"))
    os.makedirs(dest, exist_ok=True)
    paths = {k: os.path.join(dest, k) for k in
             ("vartig_dump.txt", "haplotagged.bam", "frags.txt")}
    vartig_dump.main(["-b", bam, "-v", vcf, "-o", paths["vartig_dump.txt"]])
    name_to_part = {}
    for i, names in read_haploset(haplosets, 0).items():
        for n in names:
            name_to_part[n] = i
    template = BamFile(bam)
    write_bam_records(paths["haplotagged.bam"], template,
                      haplotag_records(template, contig, name_to_part))
    cv = read_vcf(vcf, [contig]).get(contig)
    ref_seq = FastaFile(os.path.join(sim_dir, "sim.fa")).fetch(contig)
    frags, _ = get_frags_from_bam(open_bam(bam), None, cv, JaxOptions(),
                                  ref_seq, contig)
    write_frags_file(frags, paths["frags.txt"])
    back = read_frags_file(paths["frags.txt"])["frag_contig"]
    assert [(g.seq_dict, g.qual_dict) for g in back] == \
        [(dict(f.seq_dict), dict(f.qual_dict)) for f in frags]
    out = {k: chip_smoke._sha256(p, p) for k, p in paths.items()}
    out["tagged_reads"] = len(name_to_part)
    out["frags"] = len(frags)
    return out


def golden_entry(name, tmp):
    """One config's golden record from the JAX CLI; for config4 the
    port's `--device cpu` CLI must write the same bytes (else SystemExit)
    and the outputs' evaluation is added. Returns (entry, sim_dir,
    out_dir)."""
    from floria_tpu.ingest.autodetect import l_epsilon_auto_detect
    from floria_tpu.sim import evaluate as jax_evaluate
    from floria_tpu.sim.simulate import simulate, simulate_hybrid
    from floria_tpu_torch.sim import evaluate as torch_evaluate

    cfg, short, fields = case(name)
    sim_dir = os.path.join(tmp, name)
    truth = (simulate(cfg, sim_dir) if short is None else simulate_hybrid(
        cfg, sim_dir, short_coverage_per_strain=short))
    inputs = ["sim.bam", "sim.fa", "sim.vcf"]
    if short is not None:
        inputs.append("sim_short.bam")
    args = cli_args(fields)
    out_dir = os.path.join(tmp, name + "_out")
    argv = cli_argv(sim_dir, out_dir, args)
    jax_cli.main(argv)
    entry = {"sim_config": dataclasses.asdict(cfg)}
    if short is not None:
        entry["short_coverage_per_strain"] = short
    entry.update(inputs_sha256={
        f: chip_smoke._sha256(os.path.join(sim_dir, f)) for f in inputs},
                 cli_args=args,
                 outputs_sha256=chip_smoke.output_sha256(out_dir, out_dir))
    if name != "config4":
        return entry, sim_dir, out_dir
    est_l, est_e = l_epsilon_auto_detect(argv[1])
    entry["auto_detect"] = {"epsilon": est_e, "block_length": est_l}
    shutil.move(out_dir, out_dir + "_jax")
    torch_cli.main(argv + ["--device", "cpu"])
    if chip_smoke.output_sha256(out_dir, out_dir) != entry["outputs_sha256"]:
        raise SystemExit("config4: the port's --device cpu CLI differs "
                         "from the JAX CLI; nothing written")
    cdir = os.path.join(out_dir, cfg.contig_name)
    evals = []
    for mod in (jax_evaluate, torch_evaluate):
        evals.append({
            "vartigs": dataclasses.asdict(mod.evaluate_vartigs(
                os.path.join(cdir, f"{cfg.contig_name}.vartigs"), truth)),
            "haplosets": dataclasses.asdict(mod.evaluate_haplosets(
                os.path.join(cdir, f"{cfg.contig_name}.haplosets"),
                truth))})
    if evals[0] != evals[1]:
        raise SystemExit(f"config4: evaluations differ {evals}")
    entry["evaluation"] = evals[1]
    return entry, sim_dir, out_dir


if __name__ == "__main__":
    record = {"configs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for name in SMALL + ["config4"]:
            entry, sim_dir, out_dir = golden_entry(name, tmp)
            record["configs"][name] = entry
            print(f"{name}: {len(entry['outputs_sha256'])} files",
                  file=sys.stderr)
            if name == "long3":
                contig = CONFIGS["long3"].contig_name
                record["tools"] = jax_tools_outputs(
                    sim_dir, os.path.join(out_dir, contig,
                                          f"{contig}.haplosets"),
                    contig, os.path.join(tmp, "tools"))
    with open(chip_smoke.GOLDEN_NORTH_STAR, "w") as fh:
        json.dump(record, fh, indent=1)
        fh.write("\n")
    print(f"wrote {chip_smoke.GOLDEN_NORTH_STAR}", file=sys.stderr)
