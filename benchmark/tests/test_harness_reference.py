"""The plain reference against the program's CPU path, and the float32
control against the reference, at sizes a test run holds."""

import json
import os
import tempfile

import numpy as np
import pytest

from conftest import BENCH, SMALL_COMMUNITY, small_root

from harness import control, sim
from harness.blockgen import make_blocks
from harness.drivers import instances
from harness.manifest import Manifest
from reference import cli as ref_cli
from reference import phasing as ref

SPEC = {"num_blocks": 3, "reads_per_block": 80, "block_sites": 80,
        "read_length": 1800, "read_length_sd": 300.0, "snps_per_bp": 0.05,
        "sizes_seed": 16, "num_strains": 3, "error_rate": 0.02,
        "qual_lo": 10, "qual_hi": 39}


@pytest.mark.parametrize("seed,max_p", [(1, 4), (2**33 + 1, 5)])
def test_block_phasing_equals_the_programs(seed, max_p):
    from floria_tpu_torch.kernels.blocktensor import BlockTensor
    from floria_tpu_torch.options import Options
    from floria_tpu_torch.phase.local import (phase_instances,
                                              refine_instances)

    blocks = make_blocks(SPEC, seed)
    bts = [(g, BlockTensor(frag_ids=np.arange(len(al)), lo=1,
                           num_sites=al.shape[1], num_reads=len(al),
                           alleles=al, weights=ref.phred_weight(q),
                           snp_range=(1, al.shape[1]), quals=q))
           for g, (al, q) in enumerate(blocks)]
    opts = Options(epsilon=0.02, max_ploidy=max_p)
    asg = phase_instances(bts, opts, range(2, max_p + 1), device="cpu")
    refined, stats = refine_instances(bts, asg, opts,
                                      ploidies=range(1, max_p + 1),
                                      device="cpu")
    answers = {g: instances.reference_answers(
        blocks, g, range(2, max_p + 1), range(1, max_p + 1), 0.02, 10)
        for g in range(len(blocks))}
    got = {(g, P): (asg.get((g, P)), refined[(g, P)], stats[(g, P)])
           for g in range(len(blocks)) for P in range(1, max_p + 1)}
    assert instances.compare([got], answers) == [0, 0, 0]


def test_cli_texts_and_sweep_equal_the_programs(tmp_path):
    from floria_tpu_torch import cli, pipeline

    with open(os.path.join(BENCH, "configs", "config4.json")) as fh:
        config = json.load(fh)
    simc = dict(config["sim"], seed=9, **SMALL_COMMUNITY["sim"])
    sim.simulate(simc, tmp_path / "in")
    sweeps = []
    orig = pipeline.phase_contigs_blocks

    def keep(*a, **k):
        out = orig(*a, **k)
        sweeps.append([(tuple(r.snp_range),
                        [sorted(int(i) for i in ids)
                         for ids in r.part_frag_ids],
                        [float(x) for x in r.mec_vector])
                       for rs in out.values() for r in rs])
        return out

    pipeline.phase_contigs_blocks = keep
    try:
        d = tmp_path / "in"
        cli.main(["-b", str(d / "sim.bam"), "-v", str(d / "sim.vcf"),
                  "-r", str(d / "sim.fa"), "-o", str(tmp_path / "out"),
                  "--overwrite", "--device", "cpu", *config["cli"]["args"]])
    finally:
        pipeline.phase_contigs_blocks = orig
    texts, sweep = ref_cli.community_texts(str(d), config)
    got = ref_cli.read_texts(str(tmp_path / "out"), simc["contig_name"])
    assert all(texts.values()) and got == texts
    from harness.drivers import cli as drv
    assert drv.compare([(got, sweeps[0])], texts, sweep) == [0, 0, 0]


@pytest.mark.parametrize("workload,changes,number", [
    ("ecoli2.blocks", {"blocks": {"num_blocks": 4, "reads_per_block": 90,
                                  "block_sites": 60, "read_length": 2400,
                                  "read_length_sd": 400.0,
                                  "check_blocks": 4}}, "mec_mismatch"),
    ("config4.cli", SMALL_COMMUNITY, "mec_differ")])
def test_the_float32_control_is_not_correct(tmp_path, monkeypatch,
                                            workload, changes, number):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    cell = workload.split(".")[0]
    m = Manifest(root=small_root(tmp_path, cell, **changes))
    nums = control.control_numbers(m, workload, 3)
    assert nums[number] > 0, nums


def test_exact_search_is_exact_where_float32_is_not():
    """The quanta hold sums float32 rounds: the unit-weight MEC of a
    partition, with epsilon per single-read site."""
    (al, q), = make_blocks(dict(SPEC, num_blocks=1), 4)
    asg = np.arange(len(al)) % 2
    eq = ref.epsilon_quanta(0.02)
    exact = ref.unit_mec(al, eq, asg, 2)
    low = ref.unit_mec(al, np.float32(eq / ref.QUANTUM), asg, 2,
                       scale=np.float32(1.0))
    assert exact[0] == low[0] and exact[1] != low[1]
