"""The port's parallel layer (floria_tpu_torch/parallel/mesh.py, the
sharded sweep, the CLI's --num-devices, entry.py) on CPU shards, against
the JAX package on its virtual 8-device CPU mesh (tests/conftest.py):
sharded beam records, assignments and scores bitwise; the sharded step's
gathered assignments bitwise and its summed score at rtol 1e-12; the
sharded sweep's ploidies, assignments and MEC vectors bitwise, and equal
over 1, 3 and 8 shards; the CLI's bytes."""

import os
import shutil
import sys
import threading

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from chip_smoke import _tree
from floria_tpu import cli as jax_cli
from floria_tpu.kernels import beam as B
from floria_tpu.options import Options
from floria_tpu.parallel import mesh as JM
from floria_tpu.phase import local as L
from floria_tpu.sim.simulate import SimConfig, simulate
from floria_tpu_torch import cli, entry
from floria_tpu_torch.kernels import _build
from floria_tpu_torch.parallel import mesh as TM
from floria_tpu_torch.phase import local as TL
from test_torch_sweep import _assert_sweeps_equal, _blocks

# One intra-op thread: the suite runs several pytest workers on one
# host, and oversubscribed OpenMP threads slow every worker down.
torch.set_num_threads(1)


def _toy_batch(G, R=12, S=64, P=3, seed=0):
    """tests/test_parallel.py's toy batch, with mixed part counts and
    read counts."""
    rng = np.random.default_rng(seed)
    alleles = rng.integers(-1, 2, (G, R, S)).astype(np.int8)
    weights = np.where(alleles >= 0, 0.97, 0.0).astype(np.float32)
    num_reads = np.array([R - (g % 4) for g in range(G)], np.int32)
    epsilon = np.full(G, 0.02, dtype=np.float32)
    nparts = np.array([2 + g % (P - 1) for g in range(G)], np.int32)
    return alleles, weights, num_reads, epsilon, nparts


def test_make_block_mesh_on_the_cpu_and_from_lists():
    cpu = torch.device("cpu")
    assert TM.make_block_mesh(device="cpu") == [cpu]
    assert TM.make_block_mesh(8, device="cpu") == [cpu] * 8
    assert TM.make_block_mesh(device=["cpu"] * 3) == [cpu] * 3
    assert TM.make_block_mesh(2, device=["cpu"] * 3) == [cpu] * 2


def test_make_block_mesh_clamps_to_the_cards(monkeypatch):
    """As the reference clamps to its local devices: at most the cards
    this process sees, all of them by default."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert TM.make_block_mesh(device="cuda") == cards
    assert TM.make_block_mesh(5, device="cuda") == cards
    assert TM.make_block_mesh(1, device="cuda:1") == [torch.device(
        "cuda", 1)]
    assert len(jax.devices()) == 8
    assert len(JM.make_block_mesh(16).devices) == 8


@pytest.mark.parametrize("device", ["cuda:1", torch.device("cuda", 0)])
def test_make_block_mesh_keeps_a_named_card(monkeypatch, device):
    """A device that names its card is a one-card mesh, even where the
    process sees more cards: only a bare "cuda" spreads over them."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    want = [torch.device(device)]
    assert TM.make_block_mesh(device=device) == want
    assert TM.make_block_mesh(2, device=device) == want


@pytest.mark.parametrize("G,n", [(11, 8), (11, 3), (16, 8), (2, 8)])
def test_shard_bounds_are_shard_maps_split(G, n):
    """Each shard holds the instances of the reference's shard of the
    batch padded to a multiple of n."""
    G_pad = JM.pad_to_multiple(G, n)
    per = G_pad // n
    want = [(min(k * per, G), min((k + 1) * per, G)) for k in range(n)]
    assert TM.shard_bounds(G, n) == want
    assert sum(hi - lo for lo, hi in want) == G


@pytest.mark.parametrize("n", [8, 3])
def test_beam_search_sharded_matches_jax(n):
    args = _toy_batch(11)
    jmesh = JM.make_block_mesh()
    want = JM.beam_search_sharded(jmesh, *args, max_ploidy=3,
                                  beam_width=5)
    got, assign = TM.beam_search_sharded(["cpu"] * n, *args, max_ploidy=3,
                                         beam_width=5)
    assert len(want) == len(got)
    for name, a, b in zip(got._fields, want, got):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    with jax.enable_x64():
        tb = np.asarray(B.traceback_batch(tuple(want)))
    assert tb.dtype == assign.dtype
    np.testing.assert_array_equal(tb, assign)
    one, one_assign = TM.beam_search_sharded(["cpu"], *args, max_ploidy=3,
                                             beam_width=5)
    for a, b in zip(one, got):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(one_assign, assign)


@pytest.mark.parametrize("n", [8, 3])
def test_training_step_sharded_matches_jax(n):
    from jax.sharding import NamedSharding, PartitionSpec as P

    alleles, weights, num_reads, epsilon, _np = _toy_batch(8, seed=3)
    num_reads[:] = alleles.shape[1]
    jmesh = JM.make_block_mesh()
    sharding = NamedSharding(jmesh, P("block"))
    jargs = [jax.device_put(a, sharding)
             for a in (alleles, weights, num_reads, epsilon)]
    want_assign, want_total = JM.training_step_sharded(jmesh, 2, 4)(*jargs)
    step = TM.training_step_sharded(["cpu"] * n, 2, 4)
    assign, total = step(alleles, weights, num_reads, epsilon)
    want_assign = np.asarray(want_assign)
    assert assign.dtype == want_assign.dtype == np.int32
    np.testing.assert_array_equal(assign, want_assign)
    np.testing.assert_allclose(total, float(want_total), rtol=1e-12,
                               atol=0)
    assert total > 0


def _chain_spy(monkeypatch):
    """Each sweep dispatch as (thread, top level, fused, members)."""
    calls = []
    orig = TL._chain

    def spy(options, cache, members, *args):
        levels = members[0][2]
        calls.append((threading.get_ident(), levels[-1], len(levels) > 1,
                      len(members)))
        return orig(options, cache, members, *args)

    monkeypatch.setattr(TL, "_chain", spy)
    return calls


@pytest.mark.parametrize("seed", [1, 2])
def test_adaptive_sweep_sharded_matches_jax(seed, monkeypatch):
    """JAX routes its sweep through beam_search_sharded on 8 devices;
    the port splits each dispatch over 8 CPU shards, levels 1 and 2 as
    separate dispatches, each shard's chain on its own thread."""
    blocks = _blocks(6, seed)
    opts = Options(epsilon=0.02, max_ploidy=4)
    assert jax.local_device_count() == 8
    want = L.adaptive_sweep(blocks, opts)
    calls = _chain_spy(monkeypatch)
    got = TL.adaptive_sweep(blocks, opts, device=["cpu"] * 8)
    _assert_sweeps_equal(want, got)
    assert len({v[0] for v in got[0].values()}) > 1
    # Level 1 ran on its own (no fused wave), one instance per shard,
    # from several threads.
    first = [c for c in calls if c[1] == 1]
    assert len(first) == len(blocks) and not any(c[2] for c in calls)
    assert len({c[0] for c in calls}) > 1


def test_adaptive_sweep_over_1_3_and_8_shards_agree(monkeypatch):
    blocks = _blocks(7, 5)
    opts = Options(epsilon=0.02, max_ploidy=4)
    base = TL.adaptive_sweep(blocks, opts, device="cpu")
    for n in (3, 8):
        _assert_sweeps_equal(base, TL.adaptive_sweep(
            blocks, opts, device=["cpu"] * n))
    # options.num_devices shards a plain device as --num-devices does.
    calls = _chain_spy(monkeypatch)
    three = Options(epsilon=0.02, max_ploidy=4, num_devices=3)
    _assert_sweeps_equal(base, TL.adaptive_sweep(blocks, three,
                                                 device="cpu"))
    assert max(c[3] for c in calls) == 3   # ceil(7 / 3) per shard


def test_sweep_keeps_one_cache_per_device(monkeypatch):
    made = []
    orig = TL.BlockDeviceCache.__init__

    def spy(self, blocks, *, device):
        made.append(device)
        orig(self, blocks, device=device)

    monkeypatch.setattr(TL.BlockDeviceCache, "__init__", spy)
    TL.adaptive_sweep(_blocks(3, 6), Options(epsilon=0.02, max_ploidy=2),
                      device=["cpu"] * 4)
    assert made == [torch.device("cpu")]


_CLI_ARGS = ["-e", "0.02", "-l", "3000", "--snp-count-filter", "10"]


def test_cli_num_devices_matches_jax_cli(tmp_path):
    """`--device cpu --num-devices 8` against floria_tpu.cli, which sees
    8 devices and shards its sweep: the same bytes, written to the same
    path one after the other."""
    sim = str(tmp_path / "sim")
    simulate(SimConfig(contig_len=20_000, num_strains=3, num_snps=110,
                       coverage_per_strain=8.0, read_length=3_000,
                       read_length_sd=400.0, error_rate=0.01, seed=17),
             sim)
    out = str(tmp_path / "out")
    inputs = ["-b", os.path.join(sim, "sim.bam"),
              "-v", os.path.join(sim, "sim.vcf"),
              "-r", os.path.join(sim, "sim.fa"), "-o", out, "--overwrite"]
    argv = sys.argv
    try:
        sys.argv = ["floria-tpu"]
        jax_cli.main(inputs + _CLI_ARGS + ["--num-devices", "8"])
        shutil.move(out, str(tmp_path / "jax"))
        cli.main(inputs + _CLI_ARGS + ["--num-devices", "8",
                                       "--device", "cpu"])
        shutil.move(out, str(tmp_path / "torch"))
    finally:
        sys.argv = argv
    files = _tree(str(tmp_path / "jax"))
    assert files == _tree(str(tmp_path / "torch"))
    assert any(f.endswith(".vartigs") for f in files)
    for f in files:
        with open(tmp_path / "jax" / f, "rb") as a, \
                open(tmp_path / "torch" / f, "rb") as b:
            assert a.read() == b.read(), f


def test_entry_matches_graft_entry():
    fn, args = entry.entry(device="cpu")
    jfn, jargs = graft.entry()
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a, b)
    with jax.enable_x64():
        want = jax.jit(jfn)(*jargs)
    got = fn(*args)
    assert len(got) == len(want) == 6
    for name, a, b in zip(got._fields, want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=name)


def test_synth_blocks_match_graft_entry():
    for (ja, a), (jb, b) in zip(graft._synth_blocks(3, 32, 96, 3),
                                entry._synth_blocks(3, 32, 96, 3)):
        assert ja == jb
        for f in ("frag_ids", "alleles", "weights", "quals"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        assert (a.lo, a.num_sites, a.num_reads, a.snp_range) == \
            (b.lo, b.num_sites, b.num_reads, b.snp_range)


def test_dryrun_multichip_over_8_cpu_shards():
    entry.dryrun_multichip(8, device="cpu")
    with pytest.raises(ValueError, match="shards"):
        entry.dryrun_multichip(4, device=["cpu"] * 2)


def test_launch_counts_survive_concurrent_shards():
    """The shards of a mesh count their launches from several threads:
    no increment may be lost."""
    n_threads, per = 16, 2000
    _build.LAUNCHES.pop("stress", None)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ths = [threading.Thread(target=lambda: [
            _build.count_launch("stress") for _ in range(per)])
            for _ in range(n_threads)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ths)
    finally:
        sys.setswitchinterval(interval)
    assert _build.LAUNCHES.pop("stress") == n_threads * per
