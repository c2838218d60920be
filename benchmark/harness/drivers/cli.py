"""Driver of the command line: one job is `floria_tpu_torch.cli.main(argv)`
in this process on one community of the pool, with a fresh output
directory under TMPDIR, as a pipeline phasing sample after sample would
call it. Every run simulates its pool from the seed in its set-up, into a
directory under TMPDIR that is removed when the process ends."""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile

import numpy as np

from .. import sim
from reference import cli as ref_cli


def community(config, seed: int, k: int, root: str) -> dict:
    """The k-th community of the pool of `seed`, simulated under `root`:
    its directory and its read count."""
    derived = int(np.random.default_rng([int(seed), k]).integers(2**62))
    d = os.path.join(root, str(k))
    n = sim.simulate(dict(config["sim"], seed=derived), d)
    return {"dir": d, "reads": n}


def inputs_dir() -> str:
    """A fresh directory under TMPDIR for this process's inputs, removed
    when the process ends."""
    d = tempfile.mkdtemp(prefix="floria_bench_inputs_")
    atexit.register(shutil.rmtree, d, True)
    return d


def setup(config, traffic, seed, dev, rec, trace):
    from floria_tpu_torch import cli, pipeline, timing

    root = inputs_dir()
    pool = [community(config, seed, k, root)
            for k in range(config["cli"]["pool"])]
    check_k = int(np.random.default_rng([int(seed), 0xC4EC]).integers(
        len(pool)))
    ctx = {"cli": cli, "timing": timing, "pool": pool, "check_k": check_k,
           "dev": dev, "contig": config["sim"]["contig_name"],
           "config": config, "kept": [], "capture": None,
           # The warm job takes the community before the checked one, so
           # the window starts with the checked one.
           "i": (check_k - 1) % len(pool),
           "tmp": tempfile.gettempdir()}
    # The sweep's per-block results of the checked community's jobs are
    # kept from the timed path for the comparison.
    ctx["restore"] = [(m, n, getattr(m, n)) for m, n in (
        (cli, "run"), (pipeline, "collect_contig_records"),
        (pipeline, "flush_pool"), (pipeline, "finalize_frags"),
        (pipeline, "phase_contigs_blocks"), (pipeline, "_finish_contig"))]
    pipeline.phase_contigs_blocks = _captured(
        ctx, pipeline.phase_contigs_blocks)
    if trace:
        cli.run = rec.wrap("pipeline.run", cli.run)
        for name, label in (("collect_contig_records", "ingest.collect"),
                            ("flush_pool", "realign.flush"),
                            ("finalize_frags", "ingest.finalize"),
                            ("phase_contigs_blocks", "phase.sweep"),
                            ("_finish_contig", "join.contig")):
            setattr(pipeline, name,
                    rec.wrap(label, getattr(pipeline, name)))
    extra = [] if dev.type == "cuda" else ["--device", str(dev)]
    ctx["args"] = list(config["cli"]["args"]) + extra
    return ctx


def _captured(ctx, fn):
    def wrapped(*a, **k):
        out = fn(*a, **k)
        if ctx["capture"] is not None:
            ctx["capture"].extend(
                (tuple(r.snp_range), [sorted(int(i) for i in ids)
                                      for ids in r.part_frag_ids],
                 [float(x) for x in r.mec_vector])
                for blocks in out.values() for r in blocks)
        return out
    return wrapped


def run_job(ctx, rec):
    k = ctx["i"] % len(ctx["pool"])
    ctx["i"] += 1
    c = ctx["pool"][k]
    out = tempfile.mkdtemp(prefix="floria_bench_", dir=ctx["tmp"])
    argv = ["-b", os.path.join(c["dir"], "sim.bam"),
            "-v", os.path.join(c["dir"], "sim.vcf"),
            "-r", os.path.join(c["dir"], "sim.fa"),
            "-o", out, "--overwrite", *ctx["args"]]
    checked = k == ctx["check_k"] and rec.job >= 0
    ctx["capture"] = [] if checked else None
    try:
        with rec.span("cli.main"):
            ctx["cli"].main(argv)
            if ctx["dev"].type == "cuda":
                import torch
                torch.cuda.synchronize(ctx["dev"])
        if checked:
            ctx["kept"].append((ref_cli.read_texts(out, ctx["contig"]),
                                ctx["capture"]))
    finally:
        ctx["capture"] = None
        shutil.rmtree(out, ignore_errors=True)
    if rec.job >= 0:
        rec.stage_times.append(dict(ctx["timing"].STAGE_TIMES))
        rec.count("cli.reads", c["reads"])


def release(ctx):
    for mod, name, fn in ctx.pop("restore"):
        setattr(mod, name, fn)
    ctx["cli"] = None


def compare(kept, want_texts, want_sweep):
    """(texts, blocks, MEC vectors) that differ from the reference's, over
    the kept jobs: a job's sweep counts every block whose range, chosen
    partition (parts of counter ids, in part order) or MEC vector
    differs, and every block missing or extra."""
    want_blocks = [(tuple(rng), [sorted(p) for p in parts], list(mec))
                   for rng, parts, mec in want_sweep]
    bad = [0, 0, 0]
    for texts, sweep in kept:
        bad[0] += sum(1 for key in want_texts
                      if texts.get(key) != want_texts[key])
        bad[1] += abs(len(sweep) - len(want_blocks))
        for got, want in zip(sweep, want_blocks):
            bad[1] += int(got[:2] != want[:2])
            bad[2] += int(got[2] != want[2])
    return bad


def check(ctx, rec):
    c = ctx["pool"][ctx["check_k"]]
    texts, sweep = ref_cli.community_texts(c["dir"], ctx["config"])
    bad = compare(ctx["kept"], texts, sweep)
    return [("texts_differ", bad[0], 0), ("blocks_differ", bad[1], 0),
            ("mec_differ", bad[2], 0),
            ("jobs_unchecked", int(not ctx["kept"]), 0)]
