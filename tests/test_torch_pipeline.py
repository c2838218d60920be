"""End-to-end byte parity: the PyTorch port's pipeline (plain path on
the CPU) against floria_tpu.pipeline on the same simulated communities,
with -r so the port's realignment path runs. Every output file must be
byte-identical, except cmd.log. Both sides write to the same path (the
outputs embed it), one after the other.

tests/data/long3_oracle.json holds the oracle pipeline's bytes for the
`long3` community, which chip_smoke.py holds the port's CLI to on the
card (where the oracle's imports are not available). Regenerate it with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_pipeline.py
"""

import dataclasses
import hashlib
import json
import os
import sys
import tempfile

import pytest
import torch

import oracle_pipeline
from floria_tpu.options import Options
from floria_tpu.sim.simulate import SimConfig, simulate
from floria_tpu_torch import cli
from test_pipeline_oracle import CONFIGS, _ingest_like_pipeline
from test_torch_oracle_configs import run_both

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "long3_oracle.json")
# Stands for the contig's output directory, which the outputs embed.
CDIR = "<cdir>"
LONG3_ARGS = ["-e", "0.02", "-l", "4000", "--snp-count-filter", "10"]

# One intra-op thread: the suite runs several pytest workers on one
# host, and oversubscribed OpenMP threads slow every worker down.
torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["long2", "paired2"])
def test_torch_pipeline_matches_jax(name, tmp_path):
    """Both pipelines at one -o, every output file byte-equal, the JAX
    bytes equal to tests/data/north_star_golden.json's."""
    run_both(name, tmp_path)


def _sha256(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def long3_oracle(tmp_dir):
    """The golden record: long3's SimConfig, the sha256 of its simulated
    inputs, the CLI flags, and the oracle pipeline's output texts with
    the contig directory written as CDIR."""
    cfg = CONFIGS["long3"]
    sim_dir = os.path.join(tmp_dir, "sim")
    simulate(cfg, sim_dir)
    opts = Options(
        bam_file=os.path.join(sim_dir, "sim.bam"),
        vcf_file=os.path.join(sim_dir, "sim.vcf"),
        reference_fasta=os.path.join(sim_dir, "sim.fa"),
        out_dir=os.path.join(tmp_dir, "out"), epsilon=0.02,
        block_length=4000, snp_count_filter=10, overwrite=True)
    contig = cfg.contig_name
    frags, _nosnp, cv = _ingest_like_pipeline(opts, contig)
    parts, ranges, hapqs, rel, avg_err = oracle_pipeline.phase_contig(
        frags, cv.genome_pos, opts)
    with open(opts.reference_fasta) as fh:
        contig_len = sum(len(ln.strip()) for ln in fh
                         if not ln.startswith(">"))
    outputs = {
        "vartigs": oracle_pipeline.vartigs_text(
            parts, ranges, CDIR, contig, frags, cv.genome_pos, hapqs, rel),
        "haplosets": oracle_pipeline.haplosets_text(
            parts, ranges, CDIR, contig, frags, cv.genome_pos, hapqs, rel),
        "info": oracle_pipeline.vartig_info_text(
            parts, ranges, CDIR, frags, cv.genome_pos),
        "ploidy": oracle_pipeline.ploidy_row(
            parts, ranges, contig, frags, cv.genome_pos, hapqs, avg_err,
            contig_len)}
    return {"sim_config": dataclasses.asdict(cfg),
            "inputs_sha256": {f: _sha256(os.path.join(sim_dir, f))
                              for f in ("sim.bam", "sim.fa", "sim.vcf")},
            "cli_args": LONG3_ARGS, "outputs": outputs}


def _load_golden():
    with open(GOLDEN) as fh:
        return json.load(fh)


def test_long3_golden_matches_oracle(tmp_path):
    assert long3_oracle(str(tmp_path)) == _load_golden()


def test_torch_cli_long3_matches_golden(tmp_path):
    """The comparison chip_smoke.py makes on the card, on the CPU."""
    golden = _load_golden()
    sim_dir = str(tmp_path / "sim")
    simulate(SimConfig(**golden["sim_config"]), sim_dir)
    out_dir = str(tmp_path / "out")
    cli.main(["-b", os.path.join(sim_dir, "sim.bam"),
              "-v", os.path.join(sim_dir, "sim.vcf"),
              "-r", os.path.join(sim_dir, "sim.fa"), "-o", out_dir,
              "--overwrite", "--device", "cpu", *golden["cli_args"]])
    contig = golden["sim_config"]["contig_name"]
    cdir = os.path.join(out_dir, contig)
    names = {"vartigs": f"{contig}.vartigs",
             "haplosets": f"{contig}.haplosets",
             "info": "vartig_info.txt"}
    for key, name in names.items():
        with open(os.path.join(cdir, name)) as fh:
            assert fh.read().replace(cdir, CDIR) == \
                golden["outputs"][key], key
    with open(os.path.join(out_dir, "contig_ploidy_info.tsv")) as fh:
        assert fh.read().splitlines()[-1] + "\n" == \
            golden["outputs"]["ploidy"]


if __name__ == "__main__":
    with tempfile.TemporaryDirectory() as tmp:
        record = long3_oracle(tmp)
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    with open(GOLDEN, "w") as fh:
        json.dump(record, fh, indent=1)
        fh.write("\n")
    print(f"wrote {GOLDEN}", file=sys.stderr)
