"""The inputs are made from the seed, and the frozen copies equal the
program's originals."""

import hashlib
import os

import numpy as np
import pytest
import torch

from harness import roofline, sim
from harness.blockgen import block_sizes, make_blocks

SMALL_SIM = {"contig_name": "sim_contig", "contig_len": 30000,
             "num_strains": 3, "num_snps": 600, "coverage_per_strain": 6.0,
             "read_length": 5000, "read_length_sd": 800.0,
             "error_rate": 0.02, "base_qual": 20}
SPEC = {"num_blocks": 3, "reads_per_block": 40, "block_sites": 40,
        "read_length": 1200, "read_length_sd": 200.0, "snps_per_bp": 0.05,
        "sizes_seed": 16, "num_strains": 2, "error_rate": 0.02,
        "qual_lo": 10, "qual_hi": 39}


def _digest(d):
    return {f: hashlib.sha256(open(os.path.join(d, f), "rb").read()
                              ).hexdigest()
            for f in ("sim.bam", "sim.vcf", "sim.fa")}


def test_blocks_are_made_from_the_seed():
    a, b = make_blocks(SPEC, 2**31 + 5), make_blocks(SPEC, 2**31 + 5)
    c = make_blocks(SPEC, 7)
    assert all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
               for x, y in zip(a, b))
    assert not all(np.array_equal(x[0], y[0]) for x, y in zip(a, c))
    # Every seed gives the same sizes, in another order.
    assert sorted(al.shape for al, _q in a) == sorted(al.shape
                                                     for al, _q in c)
    for al, q in a:
        cov = al >= 0
        first = cov.argmax(1)
        last = al.shape[1] - 1 - cov[:, ::-1].argmax(1)
        assert al.shape[0] == 40 and ((al >= 0) == (q > 0)).all()
        assert (cov.sum(1) == last - first + 1).all()      # contiguous
        assert (np.diff(first) >= 0).all()                 # sorted
        assert first[0] == 0 and last.max() == al.shape[1] - 1
        # Each read overlaps the block's own 40 columns.
        assert al.shape[1] > 40 and cov.sum(1).min() >= 10


def test_ecoli2_blocks_fill_the_programs_largest_bucket():
    """The sizes the cell times: 151 blocks of 210 reads, most of them at
    the program's R 256, S 2,048 dispatch bucket, the rest at S 1,536."""
    import json

    from conftest import BENCH
    from floria_tpu_torch.phase.local import _bucket_reads, _bucket_sites

    with open(os.path.join(BENCH, "configs", "ecoli2.json")) as fh:
        spec = json.load(fh)["blocks"]
    buckets = {}
    for st, sp in block_sizes(spec):
        key = (_bucket_reads(len(st)), _bucket_sites(int((st + sp).max())))
        buckets[key] = buckets.get(key, 0) + 1
    assert buckets == {(256, 2048): 124, (256, 1536): 27}


def test_communities_are_made_from_the_seed(tmp_path):
    n1 = sim.simulate(dict(SMALL_SIM, seed=123456789012), tmp_path / "a")
    n2 = sim.simulate(dict(SMALL_SIM, seed=123456789012), tmp_path / "b")
    sim.simulate(dict(SMALL_SIM, seed=5), tmp_path / "c")
    assert n1 == n2 == int(6.0 * 3 * 30000 / 5000)
    assert _digest(tmp_path / "a") == _digest(tmp_path / "b")
    assert _digest(tmp_path / "a")["sim.bam"] != _digest(
        tmp_path / "c")["sim.bam"]


def test_frozen_simulator_writes_the_programs_records(tmp_path):
    """The same reads, variants and reference as the program's simulator;
    only the BGZF blocks' deflate level differs."""
    import gzip

    from floria_tpu_torch.sim.simulate import SimConfig, simulate

    sim.simulate(dict(SMALL_SIM, seed=3), tmp_path / "frozen")
    simulate(SimConfig(**SMALL_SIM, seed=3), str(tmp_path / "program"))
    a, b = _digest(tmp_path / "frozen"), _digest(tmp_path / "program")
    assert a.pop("sim.bam") != b.pop("sim.bam") and a == b
    assert gzip.decompress((tmp_path / "frozen" / "sim.bam").read_bytes()) \
        == gzip.decompress((tmp_path / "program" / "sim.bam").read_bytes())


@pytest.mark.parametrize("R,C,length", [(40, 90, 1200), (20, 30, 1800),
                                        (210, 150, 9000)])
def test_frozen_k1_counts_equal_the_programs(R, C, length):
    from floria_tpu_torch import bench
    from floria_tpu_torch.scripts import mfu

    (al, _q), = make_blocks(dict(SPEC, num_blocks=1, reads_per_block=R,
                                 block_sites=C, read_length=length), 11)
    t = torch.from_numpy(al)[None]
    nr = torch.tensor([R], dtype=torch.int32)
    for P in (2, 3, 5):
        npt = torch.tensor([P], dtype=torch.int32)
        nbytes, _ops = bench.k1_cost(t, nr, npt, P, 10)
        assert roofline.k1_bytes(al, P, 10) == nbytes
        assert roofline.k1_ops(al, P, 10) == mfu.k1_work(t, nr, npt, 10)
