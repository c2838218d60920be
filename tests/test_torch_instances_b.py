"""The port's instance API (plain path, CPU) against the JAX package on
JAX's CPU backend, part b: `upem_eval_batch`, the lockstep UPEM
(`optimize_batch`, `optimize_many` with `_GroupState`), and the
phasing entries `phase_instances` (mixed ploidies in one dispatch),
`refine_instances` (ploidies 1..5) and `phase_contig_blocks`; and the
block cache they read (`BlockDeviceCache`) against a numpy padding.

Everything is compared bitwise: assignments, distances, scores and MEC
stats are integer weight quanta (or unit counts) held in f64, and no
value here passes through a `log`. The port splits a shape bucket into
dispatches of the dispatch cap and never pads the batch; the JAX package
pads each batch to a power of two. Instances are independent, so both
give the same results, which the chunked cases check.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from floria_tpu import frag as JF
from floria_tpu.kernels import upem_batch as U
from floria_tpu.options import Options as JaxOptions
from floria_tpu.phase import local as JL
from floria_tpu_torch import constants, state, timing
from floria_tpu_torch import frag as TF
from floria_tpu_torch.bench import PLOIDIES, make_workload
from floria_tpu_torch.kernels import block_pad
from floria_tpu_torch.kernels import upem_batch as TU
from floria_tpu_torch.kernels.blocktensor import BlockTensor, pack_block
from floria_tpu_torch.options import Options
from floria_tpu_torch.phase import local as TL
from test_torch_decisions_a import jax_blocks, jax_options
from test_torch_instances_a import _same, port_blocks
from test_torch_sweep import _blocks
from test_upem_batch import _mk_block

# One intra-op thread: the suite runs several pytest workers on one
# host, and oversubscribed OpenMP threads slow every worker down.
torch.set_num_threads(1)

EPS = 0.03


def _padded(blocks, ploidy, seed):
    """test_upem_batch's batch: the blocks padded to one shape, random
    starting assignments (padding rows 0, as the reference pads)."""
    rng = np.random.default_rng(seed)
    G = len(blocks)
    R = max(b.alleles.shape[0] for b in blocks)
    S = max(b.alleles.shape[1] for b in blocks)
    alleles = np.full((G, R, S), -1, np.int8)
    weights = np.zeros((G, R, S), np.float32)
    assigns = np.zeros((G, R), np.int32)
    nreads = np.zeros(G, np.int32)
    for g, bt in enumerate(blocks):
        r, s = bt.alleles.shape
        alleles[g, :r, :s] = bt.alleles
        weights[g, :r, :s] = bt.weights
        assigns[g, :bt.num_reads] = rng.integers(0, ploidy, bt.num_reads)
        nreads[g] = bt.num_reads
    return alleles, weights, assigns, nreads, np.full(G, EPS, np.float32)


@pytest.mark.parametrize("ploidy,seed", [(2, 0), (3, 7)])
def test_upem_eval_batch_matches_jax(ploidy, seed):
    """test_upem_batch.py::test_eval_matches_numpy's block, and a padded
    batch of three with a padding row assigned -1."""
    alleles, weights, assigns, _nr, eps = _padded(
        [_mk_block(seed + k, ploidy=ploidy) for k in range(3)], ploidy, seed)
    assigns[:, -1] = -1
    want = [np.asarray(x) for x in U.upem_eval_batch(
        alleles, weights, assigns, eps, ploidy)]
    got = TU.upem_eval_batch(alleles, weights, assigns, eps, ploidy,
                             device="cpu")
    assert [tuple(x.shape) for x in got] == [
        (3, alleles.shape[1], ploidy), (3,), (3, 2)]
    for name, a, b in zip(("diff", "score", "mec"), want, got):
        assert _same(b, a), name


@pytest.mark.parametrize("ploidy", [2, 3])
def test_optimize_batch_matches_jax(ploidy):
    """test_upem_batch.py::test_optimize_batch_matches_sequential's
    batch: refined assignments and their unit MEC."""
    args = _padded([_mk_block(s, ploidy=ploidy) for s in (11, 12, 13)],
                   ploidy, 99)
    want = U.optimize_batch(*(a.copy() for a in args), ploidy)
    got = TU.optimize_batch(*args, ploidy, device="cpu")
    for name, a, b in zip(("best", "mec"), want, got):
        assert _same(b, a), name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_optimize_batch_matches_jax_lockstep_on_bench_workloads(seed):
    """test_upem_batch.py::test_upem_device_matches_host_lockstep's
    inputs (bench.py's make_workload, random starts at P=3), in the
    input's dtype."""
    alleles, weights, num_reads, eps = make_workload(4, 64, 128, seed=seed)
    assign0 = np.random.default_rng(seed + 100).integers(
        0, 3, (4, 64)).astype(np.int32)
    want = U.optimize_batch(alleles, weights, assign0.copy(), num_reads,
                            eps, 3)
    got = TU.optimize_batch(alleles, weights, assign0, num_reads, eps, 3,
                            device="cpu")
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    assert not np.array_equal(got[0], assign0)
    wide = TU.optimize_batch(alleles, weights, assign0.astype(np.int64),
                             num_reads, eps, 3, device="cpu")
    assert wide[0].dtype == np.int64
    np.testing.assert_array_equal(wide[0], want[0])


def test_optimize_many_matches_jax():
    """Two groups of different ploidy and shape driven together: each
    group's best, best_mec and diff (the diff of its best) as the JAX
    package's lockstep loop leaves them."""
    specs = [(2, (21, 22)), (3, (31, 32, 33))]
    jax_groups, port_groups = [], []
    for ploidy, seeds in specs:
        alleles, weights, assigns, nreads, eps = _padded(
            [_mk_block(s, ploidy=ploidy) for s in seeds], ploidy, ploidy)
        jax_groups.append(U._GroupState(alleles, weights, assigns.copy(),
                                        nreads, eps, ploidy))
        port_groups.append(TU._GroupState(alleles, weights, assigns, nreads,
                                          eps, ploidy, device="cpu"))
    U.optimize_many(jax_groups)
    TU.optimize_many(port_groups)
    for j, p in zip(jax_groups, port_groups):
        assert _same(p.best, j.best)
        assert _same(p.best_mec, j.best_mec)
        assert _same(p.diff, j.diff)


@pytest.fixture(scope="module")
def instances():
    """Five blocks of two shape buckets (R 64 and 32, S 256), through the
    JAX package's phase_instances at ploidies 2..5 (one mixed dispatch
    per bucket) and refine_instances at 1..5 from those assignments."""
    blocks = _blocks(3, 5) + [(j + 3, dataclasses.replace(
        bt, num_reads=min(bt.num_reads, 30),
        alleles=bt.alleles[:30], weights=bt.weights[:30],
        quals=bt.quals[:30], frag_ids=bt.frag_ids[:30]))
        for j, bt in _blocks(2, 6)]
    opts = dict(epsilon=0.02, max_ploidy=5)
    jblocks = jax_blocks(blocks)
    beam = JL.phase_instances(jblocks, JaxOptions(**opts), [2, 3, 4, 5])
    refined = JL.refine_instances(jblocks, beam, JaxOptions(**opts))
    return blocks, opts, beam, refined


def _assert_instances_same(got, want):
    assert list(got) == list(want) or set(got) == set(want)
    for key in want:
        assert _same(got[key], want[key]), key


@pytest.mark.parametrize("cap", [None, 64 * 256 * 3])
def test_phase_instances_mixed_ploidies_match_jax(instances, cap,
                                                  monkeypatch):
    """Every (block, ploidy) assignment of the mixed dispatch, the port's
    in one dispatch per bucket and in chunks of three instances."""
    blocks, opts, want, _refined = instances
    if cap is not None:
        monkeypatch.setenv("FLORIA_SWEEP_CAP_CELLS", str(cap))
    got = TL.phase_instances(port_blocks(blocks), Options(**opts),
                             [2, 3, 4, 5], device="cpu")
    assert len(got) == 4 * len(blocks)
    _assert_instances_same(got, want)
    assert {"beam.pull", "beam.unpack"} <= set(timing.STAGE_TIMES)


@pytest.mark.parametrize("mesh,cap", [
    (dict(num_devices=2), None),
    (dict(device=["cpu"] * 3), 64 * 256 * 3),
])
def test_phase_instances_sharded_matches_unsharded_and_jax(instances, mesh,
                                                           cap, monkeypatch):
    """Over a mesh of two shards (options.num_devices, as --num-devices
    gives it) and of three (a device list, with chunks of three
    instances, so some shards of a chunk are empty), every assignment
    equals the one-device port's and the JAX package's (which shards
    over JAX's virtual CPU devices)."""
    blocks, opts, want, _refined = instances
    if cap is not None:
        monkeypatch.setenv("FLORIA_SWEEP_CAP_CELLS", str(cap))
    calls = []
    real = TL.beam_kernel.beam_search_traceback
    monkeypatch.setattr(TL.beam_kernel, "beam_search_traceback",
                        lambda a, *rest, **kw: calls.append(len(a))
                        or real(a, *rest, **kw))
    one = TL.phase_instances(port_blocks(blocks), Options(**opts),
                             [2, 3, 4, 5], device="cpu")
    one_calls, calls[:] = list(calls), []
    options = Options(**opts, num_devices=mesh.get("num_devices"))
    got = TL.phase_instances(port_blocks(blocks), options, [2, 3, 4, 5],
                             device=mesh.get("device", "cpu"))
    # Each shard of a dispatch is its own launch: more launches than the
    # one-device run's, over the same instances.
    assert sum(calls) == sum(one_calls) == 4 * len(blocks)
    assert len(calls) > len(one_calls)
    _assert_instances_same(got, one)
    _assert_instances_same(got, want)


def test_mesh_caches_take_a_card_named_either_way(monkeypatch):
    """A cache built on "cuda" serves a mesh that names the current card
    ("cuda:0"), and one built on "cuda:0" a mesh of "cuda": both are the
    same card (`same_card`). A card the mesh lacks is refused."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    blocks = port_blocks(_blocks(1, 5))
    cache = TL.BlockDeviceCache(blocks, device="cpu")
    for own, mesh in (("cuda", "cuda:0"), ("cuda:0", "cuda")):
        cache.device = torch.device(own)
        assert TL._mesh_caches(blocks, cache, [torch.device(mesh)] * 2) == [
            cache, cache]
    with pytest.raises(ValueError, match="cache lives on cuda:0, not on "
                       "cuda:1"):
        TL._mesh_caches(blocks, cache, [torch.device("cuda", 1)])


@pytest.mark.parametrize("cap", [None, 64 * 256 * 2])
def test_refine_instances_at_ploidies_1_to_5_match_jax(instances, cap,
                                                       monkeypatch):
    """The climb and the unit MEC of every (block, ploidy) from the JAX
    beam's assignments, ploidy 1 from all zeros: assignments and
    (bases, errors) equal, the port unpadded and in chunks of two."""
    blocks, opts, beam, (want_ref, want_stats) = instances
    if cap is not None:
        monkeypatch.setenv("FLORIA_SWEEP_CAP_CELLS", str(cap))
    got_ref, got_stats = TL.refine_instances(
        port_blocks(blocks), beam, Options(**opts), device="cpu")
    assert len(got_ref) == 5 * len(blocks)
    _assert_instances_same(got_ref, want_ref)
    assert got_stats == want_stats
    for j, bt in blocks:
        assert not got_ref[(j, 1)].any()
    assert {"upem.launch", "upem.pull"} <= set(timing.STAGE_TIMES)
    cache = TL.BlockDeviceCache(port_blocks(blocks), device="cpu")
    again = TL.refine_instances(port_blocks(blocks), beam, Options(**opts),
                                cache, ploidies=[1, 4], device="cpu")
    assert set(again[0]) == {(j, p) for j, _bt in blocks for p in (1, 4)}
    assert all(again[1][k] == want_stats[k] for k in again[1])


def _contig_frags(mod, seed=3, n_reads=90, n_snps=80, ploidy=3):
    """Sorted, frozen fragments of `mod`'s Frag over n_snps SNPs spaced
    100 bp apart, reads of 10-25 SNPs from one haplotype where they start
    in the contig's first half, else from `ploidy` haplotypes."""
    rng = np.random.default_rng(seed)
    hap = rng.integers(0, 2, (ploidy, n_snps))
    frags = []
    for i in range(n_reads):
        s0 = int(rng.integers(1, n_snps - 8))
        k = int(rng.integers(0, 1 if s0 < n_snps // 2 else ploidy))
        f = mod.Frag(f"r{i}", i, False)
        for snp in range(s0, min(n_snps, s0 + int(rng.integers(10, 26)))
                         + 1):
            allele = int(hap[k, snp - 1])
            if rng.random() < 0.03:
                allele = 1 - allele
            f.add_site(snp, allele, int(rng.integers(8, 40)), 0, 0)
        f.freeze()
        frags.append(f)
    frags.sort(key=mod.Frag.sort_key)
    for i, f in enumerate(frags):
        f.counter_id = i
    return frags, np.arange(1, n_snps + 1, dtype=np.int64) * 100


def test_phase_contig_blocks_matches_jax():
    opts = dict(epsilon=0.03, max_ploidy=4, block_length=2500)
    frags, pos = _contig_frags(JF)
    want = JL.phase_contig_blocks(frags, pos, JaxOptions(**opts))
    frags, pos = _contig_frags(TF)
    got = TL.phase_contig_blocks(frags, pos, Options(**opts), device="cpu")
    assert len(want) > 1 and len(got) == len(want)
    assert len({r.best_ploidy for r in got}) > 1
    for a, b in zip(got, want):
        assert (a.block_index, a.snp_range, a.best_ploidy) == (
            b.block_index, b.snp_range, b.best_ploidy)
        assert _same(a.mec_vector, b.mec_vector)
        assert len(a.part_frag_ids) == len(b.part_frag_ids)
        for x, y in zip(a.part_frag_ids, b.part_frag_ids):
            assert _same(x, y)


def test_instance_entries_refuse_a_cache_of_another_device():
    blocks = port_blocks(_blocks(1, 5))
    cache = TL.BlockDeviceCache(blocks, device="cpu")
    cache.device = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="cache lives on cuda:0"):
        TL.phase_instances(blocks, Options(), [2], cache, device="cpu")
    with pytest.raises(ValueError, match="cache lives on cuda:0"):
        TL.refine_instances(blocks, {}, Options(), cache, device="cpu")


def _packed_block(seed, num_reads, num_snps):
    """A block from the port's pack_block (rows and columns padded to 8,
    quals beside the alleles): reads of 1-12 SNPs, alleles 0-2."""
    rng = np.random.default_rng(seed)
    frags = []
    for i in range(num_reads):
        start = int(rng.integers(1, num_snps + 1))
        f = TF.Frag(f"r{i}", i, False)
        for snp in range(start, min(num_snps, start + 11) + 1):
            f.add_site(snp, int(rng.integers(0, 3)),
                       int(rng.integers(1, 60)), 0, 0)
        f.freeze()
        frags.append(f)
    frags.sort(key=TF.Frag.sort_key)
    return pack_block(frags, (1, num_snps))


def _harness_block(seed, num_reads, num_sites, uncovered=()):
    """A block as the instance-API benchmark builds one: arrays of exactly
    [num_reads, num_sites], rows `uncovered` all uncovered."""
    rng = np.random.default_rng(seed)
    al = rng.integers(-1, 2, size=(num_reads, num_sites)).astype(np.int8)
    al[list(uncovered)] = -1
    q = np.where(al >= 0, rng.integers(1, 60, al.shape), 0).astype(np.uint8)
    return BlockTensor(frag_ids=np.arange(num_reads), lo=1,
                       num_sites=num_sites, num_reads=num_reads, alleles=al,
                       weights=q.astype(np.float32),
                       snp_range=(1, num_sites), quals=q)


_CACHE_CASES = {
    "pack_block": lambda: [(j, _packed_block(j, r, s)) for j, (r, s) in
                           enumerate([(37, 90), (20, 45), (60, 100)])],
    "unpadded": lambda: [(j, _harness_block(j, r, s)) for j, (r, s) in
                         enumerate([(210, 1436), (199, 1529), (201, 1500)])],
    "mixed_buckets": lambda: [
        (("a", j), _packed_block(10 + j, r, s)) for j, (r, s) in
        enumerate([(9, 30), (100, 300), (40, 50)])] + [
        (("b", j), _harness_block(20 + j, r, s)) for j, (r, s) in
        enumerate([(1, 1), (130, 700), (16, 1025), (33, 129)])],
    # num_sites at its bucket's s_pad, num_reads at its r_pad.
    "full_bucket": lambda: [(0, _harness_block(3, 64, 256)),
                            (1, _harness_block(4, 64, 200))],
    # An all-uncovered read, and a bucket of one all-uncovered block
    # (amax 2, as max(2, .) gives).
    "uncovered_read": lambda: [(0, _harness_block(5, 50, 300, (0, 17))),
                               (1, _harness_block(6, 5, 70, range(5)))],
    # Staged by several threads: a bucket of 7 blocks, the largest
    # allele in the last thread's run.
    "threads": lambda: [(j, _harness_block(30 + j, 40, 500 + j))
                        for j in range(7)],
}


@pytest.mark.parametrize("case", sorted(_CACHE_CASES))
def test_block_cache_equals_a_numpy_padding(case, monkeypatch):
    """BlockDeviceCache (staged cells padded by block_pad's plain version
    on the CPU) against the padding built here in numpy, byte for byte:
    each bucket's alleles and quals, each block's row and each bucket's
    amax; and what it counts as crossing: each block's own cells twice
    (alleles and quals), 24 bytes of table a block and the phred
    table."""
    blocks = _CACHE_CASES[case]()
    if case == "threads":
        monkeypatch.setattr(block_pad, "STAGE_CELLS", 1000)
        blocks[-1][1].alleles[-1, -1] = 2
    with timing.span("cache.case") as root:
        cache = TL.BlockDeviceCache(blocks, device="cpu")
    buckets = {}
    for j, bt in blocks:
        buckets.setdefault(TL._bucket(bt), []).append((j, bt))
    assert set(cache.dev) == set(buckets)
    for key, members in buckets.items():
        alleles = np.full((len(members), *key), -1, np.int8)
        quals = np.zeros((len(members), *key), np.uint8)
        for b, (j, bt) in enumerate(members):
            r, s = bt.alleles.shape
            alleles[b, :r, :s] = bt.alleles
            quals[b, :r, :s] = bt.quals
            assert cache.rows[j] == b
        assert _same(cache.dev[key][0], alleles), key
        assert _same(cache.dev[key][1], quals), key
        assert cache.amax[key] == min(constants.MAX_ALLELES,
                                      max(2, int(alleles.max()) + 1))
    h2d = sum(r.counts.get("h2d_bytes", 0) for r in timing.records()
              if r.job == root.job)
    assert h2d == (sum(2 * bt.num_reads * bt.num_sites + 24
                       for _j, bt in blocks) + state.phred_table().nbytes)


def jax_instance_case(blocks, options, chunk=16):
    """One case of instances_golden.json: the JAX package's
    phase_instances at floria_tpu_torch.bench.PLOIDIES and refine_instances at
    1..options.max_ploidy on JAX blocks and Options, `chunk` blocks per
    call (instances are independent; the chunks bound the memory of
    JAX's unchunked dispatches), as the blocks' digest and
    chip_smoke.instance_digests."""
    import chip_smoke

    beam, refined, stats = {}, {}, {}
    for lo in range(0, len(blocks), chunk):
        part = blocks[lo:lo + chunk]
        b = JL.phase_instances(part, options, PLOIDIES)
        r, s = JL.refine_instances(part, b, options,
                                   ploidies=range(1, options.max_ploidy + 1))
        beam.update(b)
        refined.update(r)
        stats.update(s)
    return {"blocks_sha256": chip_smoke.blocks_sha256(blocks),
            **chip_smoke.instance_digests(beam, refined, stats)}


def jax_sweep_blocks(sim_dir, out_dir):
    """The blocks and Options of the JAX CLI's one sweep on the inputs in
    `sim_dir` (its phase.local.adaptive_sweep call)."""
    import chip_smoke
    from floria_tpu import cli as jax_cli
    from floria_tpu import pipeline as jax_pipeline

    with chip_smoke.SweepRecorder((JL, jax_pipeline, None)) as rec:
        jax_cli.main(["-b", os.path.join(sim_dir, "sim.bam"),
                      "-v", os.path.join(sim_dir, "sim.vcf"),
                      "-r", os.path.join(sim_dir, "sim.fa"),
                      "-o", out_dir, "--overwrite"])
    assert len(rec.sweeps) == 1, len(rec.sweeps)
    return rec.sweeps[0][:2]


def write_instances_golden(path, shapes=None, sim=None, chunk=16):
    """instances_golden.json from the JAX package on the CPU: bench.py's
    kernel shapes (chip_smoke.bench_blocks) and the blocks of the JAX
    CLI's sweep on bench.py's ecoli2 community (`sim`: SimConfig
    fields), each through jax_instance_case; the ecoli2 case also holds
    the inputs' sha256."""
    import sys
    import tempfile
    import time

    import chip_smoke
    from floria_tpu.sim.simulate import SimConfig, simulate

    record = {"cases": {}}
    for G, R, S in shapes or chip_smoke.BENCH_SHAPES:
        t0 = time.time()
        blocks, opts = chip_smoke.bench_blocks(G, R, S)
        record["cases"][f"bench {G}x{R}x{S}"] = jax_instance_case(
            jax_blocks(blocks), jax_options(opts), chunk)
        print(f"bench {G}x{R}x{S}: {time.time() - t0:.1f} s",
              file=sys.stderr, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        sim_dir = os.path.join(tmp, "ecoli2")
        simulate(SimConfig(**(sim or chip_smoke.ECOLI2)), sim_dir)
        blocks, opts = jax_sweep_blocks(sim_dir, os.path.join(tmp, "out"))
        print(f"ecoli2 CLI: {time.time() - t0:.1f} s, {len(blocks)} blocks",
              file=sys.stderr, flush=True)
        case = jax_instance_case(blocks, opts, chunk)
        case["inputs_sha256"] = chip_smoke.input_sha256(sim_dir)
        record["cases"]["ecoli2"] = case
        print(f"ecoli2: {time.time() - t0:.1f} s", file=sys.stderr,
              flush=True)
    with open(path, "w") as fh:
        json.dump(record, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(f"wrote {path}", file=sys.stderr)


# A small community for the CPU run of the smoke's `instances` phase.
SMALL_SIM = dict(contig_len=30_000, num_strains=2, num_snps=300,
                 coverage_per_strain=6.0, read_length=4_000,
                 read_length_sd=500.0, error_rate=0.02, seed=3)
SMALL_SHAPES = ((4, 32, 64), (2, 40, 300))


def test_smoke_instances_phase_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.instances_phase, the smoke's `instances` phase, on the
    CPU at small shapes: a golden record written here by the JAX
    package's phase_instances / refine_instances (write_instances_golden)
    holds the port's results, every K1 dispatch and climb holds its
    plain version, and one changed digest fails the hold."""
    import chip_smoke
    from floria_tpu_torch.sim.simulate import SimConfig, simulate
    from test_torch_decisions_a import record_run

    golden = tmp_path / "golden.json"
    write_instances_golden(str(golden), SMALL_SHAPES, SMALL_SIM, chunk=3)
    monkeypatch.setattr(chip_smoke, "GOLDEN_INSTANCES", str(golden))
    monkeypatch.setattr(chip_smoke, "BENCH_SHAPES", SMALL_SHAPES)
    sim_dir = str(tmp_path / "sim")
    simulate(SimConfig(**SMALL_SIM), sim_dir)
    rec = record_run(sim_dir, str(tmp_path / "out"))
    (blocks, opts, *_rest), = rec.sweeps
    got = chip_smoke.instances_phase(torch.device("cpu"), (blocks, opts))
    assert got["max_abs_err"] == {"beam_scan": 0.0, "upem_climb": 0.0}
    for case in ("bench 4x32x64", "bench 2x40x300", "ecoli2"):
        c = got["cases"][case]
        assert c["golden_differing"] == 0 and c["golden_compared"] == (
            c["beam_instances"] + c["climb_instances"]) > 0
        assert c["climb_instances"] == 5 * c["beam_instances"] // 4
    assert got["cases"]["bench 4x32x64"]["launches"] == {}
    assert got["baseline_faithful_reads_per_s"] > 0
    record = json.loads(golden.read_text())
    key = sorted(record["cases"]["ecoli2"]["refine"])[0]
    record["cases"]["ecoli2"]["refine"][key] = "0" * 16
    golden.write_text(json.dumps(record))
    beam = TL.phase_instances(blocks, opts, [2, 3, 4, 5], device="cpu")
    digests = chip_smoke.instance_digests(
        beam, *TL.refine_instances(blocks, beam, opts, device="cpu"))
    with pytest.raises(AssertionError, match="1 of"):
        chip_smoke.hold_instance_golden("ecoli2", blocks, digests)


def test_instances_golden_holds_the_smoke_bench_blocks():
    """tests/data/instances_golden.json's bench cases were written on the
    blocks chip_smoke.bench_blocks makes from bench.py's make_workload
    (the smoke refuses a golden of other blocks), with a digest for
    every (block, ploidy): ploidies 2..5 of the beam, 1..5 of the
    climb."""
    import chip_smoke

    with open(chip_smoke.GOLDEN_INSTANCES) as fh:
        cases = json.load(fh)["cases"]
    assert sorted(cases) == ["bench 32x256x256", "bench 8x320x2048",
                             "ecoli2"]
    for G, R, S in chip_smoke.BENCH_SHAPES:
        case = cases[f"bench {G}x{R}x{S}"]
        blocks, _opts = chip_smoke.bench_blocks(G, R, S)
        assert case["blocks_sha256"] == chip_smoke.blocks_sha256(blocks)
        assert sorted(case["beam"]) == sorted(
            f"{g}|{p}" for g in range(G) for p in (2, 3, 4, 5))
        assert sorted(case["refine"]) == sorted(
            f"{g}|{p}" for g in range(G) for p in range(1, 6))
    assert (len(cases["ecoli2"]["beam"]), len(cases["ecoli2"]["refine"])
            ) == (4 * 151, 5 * 151)


if __name__ == "__main__":
    # python tests/test_torch_instances_b.py [PATH]
    import sys

    write_instances_golden(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.join(os.path.dirname(
                               os.path.abspath(__file__)), "data",
                               "instances_golden.json"))
