"""The port's span recorder (floria_tpu_torch/timing.py): parents, jobs,
self time, adoption into threads, counts, the ring's bound, the
clock, the DEBUG exporter, the block cache's byte count and one CLI job's
spans."""

import logging
import threading
import time

import numpy as np
import pytest
import torch

from floria_tpu_torch import cli, state, timing
from floria_tpu_torch.kernels.blocktensor import BlockTensor
from floria_tpu_torch.parallel.mesh import run_on_shards
from floria_tpu_torch.phase import local as TL

# One intra-op thread: the suite runs several pytest workers on one
# host, and oversubscribed OpenMP threads slow every worker down.
torch.set_num_threads(1)


def _clock(*ticks):
    it = iter(ticks)
    return lambda: next(it)


def test_parents_jobs_and_self_time_on_a_set_clock():
    rec = timing.Recorder(clock=_clock(0.0, 1.0, 3.0, 4.0, 6.0, 10.0,
                                       20.0, 21.0))
    with rec.span("root"):
        with rec.span("a"):
            pass
        with rec.span("b"):
            pass
    with rec.span("next"):
        pass
    a, b, root, nxt = rec.records()
    assert (a.name, b.name, root.name, nxt.name) == ("a", "b", "root",
                                                     "next")
    assert root.parent is None and a.parent == b.parent == root.id
    assert a.job == b.job == root.job != nxt.job
    assert (root.start, root.end, a.start, a.end) == (0.0, 10.0, 1.0, 3.0)
    own = timing.self_seconds(rec.records())
    assert own[root.id] == 10.0 - 2.0 - 2.0
    assert own[a.id] == 2.0 and own[nxt.id] == 1.0
    # The second root cleared the first job's stage times.
    assert rec.stage_times == {"next": 1.0}


def test_stage_times_sum_the_newest_job_by_name():
    rec = timing.Recorder(clock=_clock(0.0, 1.0, 2.0, 3.0, 5.0, 9.0))
    with rec.span("root"):
        for _ in range(2):
            with rec.span("step"):
                pass
    assert rec.stage_times == {"step": 1.0 + 2.0, "root": 9.0}


def test_a_thread_adopts_the_job_and_parent():
    rec = timing.Recorder()
    with rec.span("root") as root:
        ctx = rec.current()
        assert ctx is root

        def work():
            with rec.adopt(ctx):
                with rec.span("worker"):
                    time.sleep(0.01)
        th = threading.Thread(target=work)
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
    worker, root_rec = rec.records()
    assert worker.parent == root_rec.id and worker.job == root_rec.job
    assert worker.thread != root_rec.thread
    # A child on another thread does not take from its parent's self time.
    own = timing.self_seconds(rec.records())
    assert own[root_rec.id] == pytest.approx(root_rec.end - root_rec.start)
    assert rec.stage_times["worker"] > 0


def test_shard_threads_carry_the_callers_job():
    def shard(k):
        with timing.span(f"shard{k}"):
            return k

    with timing.span("shards.root") as root:
        assert run_on_shards(shard, [0, 1, 2]) == [0, 1, 2]
    recs = [r for r in timing.records() if r.job == root.job]
    shards = [r for r in recs if r.name in ("shard0", "shard1", "shard2")]
    assert len(shards) == 3
    assert all(r.parent == root.id for r in shards)


def test_counts_go_to_the_innermost_open_span():
    rec = timing.Recorder()
    rec.count("lost", 1)                  # no span open: kept by none
    with rec.span("outer"):
        rec.count("bytes", 5)
        with rec.span("inner"):
            rec.count("bytes", 7)
            rec.count("bytes", 1)
        rec.count("other", 2)
    inner, outer = rec.records()
    assert inner.counts == {"bytes": 8}
    assert outer.counts == {"bytes": 5, "other": 2}


def test_the_ring_drops_its_oldest_and_counts_them():
    rec = timing.Recorder(capacity=4)
    for k in range(10):
        with rec.span(f"s{k}"):
            pass
    assert rec.dropped == 6
    assert [r.name for r in rec.records()] == ["s6", "s7", "s8", "s9"]


def test_a_span_reads_the_perf_counter():
    t0 = time.perf_counter()
    with timing.span("clocked") as sp:
        time.sleep(0.002)
    t1 = time.perf_counter()
    r = [r for r in timing.records() if r.id == sp.id][0]
    assert t0 <= r.start < r.end <= t1


def test_a_root_logs_its_spans_at_debug(caplog):
    caplog.set_level(logging.DEBUG, logger="floria_tpu")
    with timing.span("export.root"):
        for _ in range(3):
            with timing.span("export.child"):
                timing.count("h2d_bytes", 10)
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("span export.")]
    assert len(lines) == 2
    assert lines[0].startswith("span export.root: 1 x, ")
    assert lines[1].startswith("span export.child: 3 x, ")
    assert lines[1].endswith(", h2d_bytes 30")


def _block(R, S, seed):
    rng = np.random.default_rng(seed)
    al = rng.integers(-1, 2, size=(R, S)).astype(np.int8)
    q = np.where(al >= 0, 30, 0).astype(np.uint8)
    return BlockTensor(frag_ids=np.arange(R), lo=1, num_sites=S,
                       num_reads=R, alleles=al,
                       weights=q.astype(np.float32), snp_range=(1, S),
                       quals=q)


def test_the_block_cache_counts_the_bytes_it_places():
    blocks = [(g, _block(R, S, g)) for g, (R, S) in enumerate(
        [(20, 100), (30, 120), (100, 300), (90, 700)])]
    with timing.span("cache.root") as root:
        cache = TL.BlockDeviceCache(blocks, device="cpu")
    recs = [r for r in timing.records() if r.job == root.job]
    up, = [r for r in recs if r.name == "beam.cache_upload"]
    buckets = {}
    for _g, bt in blocks:
        key = (TL._bucket_reads(bt.num_reads),
               TL._bucket_sites(bt.num_sites))
        buckets[key] = buckets.get(key, 0) + 1
    assert len(buckets) == 3
    # What crosses: each block's own cells (alleles and quals), each
    # bucket's table of 3 int64 a block, and the phred table.
    want = (sum(2 * bt.num_reads * bt.num_sites + 24 for _g, bt in blocks)
            + state.phred_table().nbytes)
    under = [r for r in recs if r.parent == up.id]
    assert sorted(r.name for r in under) == sorted(
        ["beam.cache_stage", "beam.cache_pad"] * len(buckets))
    assert sum(r.counts.get("h2d_bytes", 0) for r in under + [up]) == want
    padded = sum(B * r_pad * s_pad * 2
                 for (r_pad, s_pad), B in buckets.items())
    assert sum(a.numel() + q.numel()
               for a, q in cache.dev.values()) == padded


def test_a_cli_job_holds_its_stages_in_one_job(tmp_path):
    from floria_tpu_torch.sim.simulate import SimConfig, simulate

    sim = str(tmp_path / "sim")
    simulate(SimConfig(contig_len=20_000, num_strains=2, num_snps=100,
                       coverage_per_strain=8.0, read_length=3_000,
                       read_length_sd=400.0, error_rate=0.01, seed=7), sim)
    last = max((r.id for r in timing.records()), default=0)
    cli.main(["-b", sim + "/sim.bam", "-v", sim + "/sim.vcf",
              "-r", sim + "/sim.fa", "-o", str(tmp_path / "out"),
              "--overwrite", "--device", "cpu", "-t", "1",
              "--snp-count-filter", "10"])
    new = [r for r in timing.records() if r.id > last]
    main, = [r for r in new if r.name == "cli.main"]
    assert main.parent is None
    assert all(r.job == main.job for r in new) and len(new) < 1000
    est, = [r for r in new if r.name == "cli.estimate"]
    assert est.parent == main.id
    assert {"cli.main", "cli.estimate", "pipeline.run", "pipeline.open",
            "ingest_realign", "phasing", "phase.pack", "join_outputs",
            "join.wait"} <= set(timing.STAGE_TIMES)
    # The join runs on a worker thread in cli.main's job.
    join, = [r for r in new if r.name == "join_outputs"]
    assert join.thread != main.thread
    assert all(main.start <= r.start <= r.end <= main.end for r in new)
