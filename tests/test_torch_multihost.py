"""The port's multi-process layer (floria_tpu_torch/parallel/multihost.py
and the CLI's --num-processes) against the JAX package's: the contig
shards, the SNP-count sidecar, the TSV merge, the TCPStore barrier, and
real two-process CLI runs (processes that refuse jax and `floria_tpu`,
the store on a free localhost port) on tests/test_multihost.py's
four-contig community, byte-equal to one process and to the JAX
package's output."""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from floria_tpu import cli as jax_cli
from floria_tpu import constants
from floria_tpu.options import Options as JaxOptions
from floria_tpu.parallel import multihost as JMH
from floria_tpu_torch.options import Options
from floria_tpu_torch.parallel import multihost as TMH
from test_multihost import _build_multi_sim, _free_port
from test_torch_jaxfree import _REFUSE, _UNLOADED

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One intra-op thread: the suite runs several pytest workers on one
# host, and oversubscribed OpenMP threads slow every worker down.
torch.set_num_threads(1)

# tests/test_multihost.py's worker options, as CLI flags.
_ARGS = ["-e", "0.02", "-l", "3000", "--snp-count-filter", "10",
         "--overwrite", "--device", "cpu"]

_RANK = _REFUSE + r"""
import torch
torch.set_num_threads(1)
from floria_tpu_torch import cli
cli.main(sys.argv[1:])
""" + _UNLOADED


@pytest.mark.parametrize("case", ["unweighted", "giant", "uniform",
                                  "random"])
def test_contigs_for_process_matches_jax(case):
    rng = np.random.default_rng(7)
    for nproc in (1, 2, 3, 4, 5):
        for n in (1, 4, 11, 13, 40):
            contigs = [f"c{i}" for i in range(n)]
            weights = {
                "unweighted": None,
                "giant": [1000.0] + [10.0] * (n - 1),
                "uniform": [5.0] * n,
                "random": [float(w) for w in rng.integers(0, 400, n)],
            }[case]
            got = [TMH.contigs_for_process(contigs, p, nproc, weights)
                   for p in range(nproc)]
            assert got == [JMH.contigs_for_process(contigs, p, nproc,
                                                   weights)
                           for p in range(nproc)]
            assert sorted(c for s in got for c in s) == sorted(contigs)
    with pytest.raises(ValueError, match="mismatch"):
        TMH.contigs_for_process(["a", "b"], 0, 2, [1.0])


def test_merge_ploidy_tsvs_matches_jax(tmp_path):
    rows = {0: ["c0\t1.0\n", "c3\t2.0\n", "\n"], 1: ["c1\t1.5\n"],
            2: ["c2\t3.0\n"]}
    outs = {}
    for side, merge, opts in (("jax", JMH._merge_ploidy_tsvs, JaxOptions),
                              ("torch", TMH._merge_ploidy_tsvs, Options)):
        d = tmp_path / side
        d.mkdir()
        for pid, lines in rows.items():
            with open(d / f"contig_ploidy_info.{pid}.tsv", "w") as f:
                f.write(constants.CONTIG_PLOIDY_HEADER)
                f.writelines(lines)
        merge(opts(out_dir=str(d)), ["c0", "c1", "c2", "c3", "c9"])
        outs[side] = (d / "contig_ploidy_info.tsv").read_text()
    assert outs["torch"] == outs["jax"]
    assert [ln.split("\t")[0] for ln in outs["torch"].splitlines()[1:]] \
        == ["c0", "c1", "c2", "c3"]


@pytest.fixture(scope="module")
def multihost_sim(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("mh_sim"))
    return base, _build_multi_sim(base)


def test_contig_snp_counts_match_jax(multihost_sim, tmp_path,
                                     monkeypatch):
    base, names = multihost_sim
    monkeypatch.setenv("FLORIA_TPU_CACHE", str(tmp_path / "jax_cache"))
    vcf = os.path.join(base, "multi.vcf")
    want = JMH._contig_snp_counts(vcf)
    assert sorted(want) == sorted(names)
    # Twice: the second read comes from the sidecar.
    assert TMH._contig_snp_counts(vcf) == want
    assert TMH._contig_snp_counts(vcf) == want


def _ranks(fn, n):
    """fn(rank) on n threads; (results, exceptions) by rank."""
    res, errs = [None] * n, [None] * n

    def go(k):
        try:
            res[k] = fn(k)
        except Exception as e:  # re-raised by the caller's checks
            errs[k] = e

    ths = [threading.Thread(target=go, args=(k,)) for k in range(n)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ths)
    return res, errs


@pytest.mark.parametrize("failing", [None, 1, 0])
def test_barrier_waits_for_every_rank_and_reports_failures(failing):
    coord = f"127.0.0.1:{_free_port()}"

    def rank(k):
        store = TMH.initialize_distributed(coord, 3, k)
        return TMH._barrier(store, 3, k, failed=k == failing)

    res, errs = _ranks(rank, 3)
    assert errs == [None] * 3
    assert res == [failing is None] * 3


def test_ranks_on_one_host_split_its_worker_budget():
    """Three ranks on this host: each keeps a third of -t for its native
    pools, and torch's pool stays at one thread here."""
    coord = f"127.0.0.1:{_free_port()}"

    def rank(k):
        store = TMH.initialize_distributed(coord, 3, k)
        opts = Options(num_threads=10)
        TMH._share_host_cores(store, opts, 3, k)
        TMH._barrier(store, 3, k, failed=False)
        return opts.num_threads

    res, errs = _ranks(rank, 3)
    assert errs == [None] * 3
    assert res == [3] * 3
    assert torch.get_num_threads() == 1


def test_initialize_distributed_checks_its_arguments():
    assert TMH.initialize_distributed(None, 1, 0) is None
    with pytest.raises(ValueError, match="coordinator"):
        TMH.initialize_distributed(None, 2, 0)
    with pytest.raises(ValueError, match="process-id"):
        TMH.initialize_distributed("127.0.0.1:1", 2, 2)


def _opts(base, out, **kw):
    return Options(bam_file=os.path.join(base, "multi.bam"),
                   vcf_file=os.path.join(base, "multi.vcf"),
                   reference_fasta=os.path.join(base, "multi.fa"),
                   out_dir=out, epsilon=0.02, block_length=3000,
                   snp_count_filter=10, overwrite=True, **kw)


def test_a_failing_rank_fails_the_run_without_a_merge(multihost_sim,
                                                      tmp_path,
                                                      monkeypatch):
    """Rank 1's phasing raises: it still reaches the barrier (rank 0
    does not wait for it forever) and raises its own error; rank 0
    raises without merging."""
    from floria_tpu_torch import pipeline

    base, _names = multihost_sim
    out = str(tmp_path / "out")
    coord = f"127.0.0.1:{_free_port()}"

    def run(options, *, device):
        if options.ploidy_tsv.endswith(".1.tsv"):
            raise RuntimeError("rank 1 broke")

    monkeypatch.setattr(pipeline, "run", run)
    _res, errs = _ranks(lambda k: TMH.run_multihost(
        _opts(base, out), 2, k, coord, device="cpu"), 2)
    assert "rank 1 broke" in str(errs[1])
    assert "another rank failed" in str(errs[0])
    assert not os.path.exists(os.path.join(out, "contig_ploidy_info.tsv"))


def _inputs(base, out):
    return ["-b", os.path.join(base, "multi.bam"),
            "-v", os.path.join(base, "multi.vcf"),
            "-r", os.path.join(base, "multi.fa"), "-o", out]


def _spawn(base, out, nproc, extra=()):
    """The port's CLI as `nproc` ranks, each in a process that refuses
    jax and `floria_tpu`; raises unless every rank exits 0."""
    flags = ["--num-processes", str(nproc)]
    if nproc > 1:
        flags += ["--coordinator", f"127.0.0.1:{_free_port()}"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    # Each rank logs to a file: a rank blocked on a full pipe would hold
    # the other at the barrier.
    logs = [f"{out}.{nproc}.rank{k}.log" for k in range(nproc)]
    procs = []
    try:
        for k, log in enumerate(logs):
            with open(log, "w") as fh:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", _RANK.format(repo=REPO),
                     *_inputs(base, out), *_ARGS, *flags, "--process-id",
                     str(k), *extra], stdout=fh, stderr=subprocess.STDOUT,
                    env=env))
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        with open(log) as fh:
            assert p.returncode == 0, fh.read()[-4000:]


def _files(root):
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            if f != "cmd.log":
                path = os.path.join(d, f)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, root)] = fh.read()
    return out


def test_two_process_cli_matches_one_process_and_jax(multihost_sim,
                                                     tmp_path):
    """One JAX-package process, one port process and two port ranks
    write to the same -o path in turn: the same bytes (the ranks' own
    summary TSVs, the merge's inputs, aside)."""
    base, names = multihost_sim
    out = str(tmp_path / "out")
    argv = sys.argv
    try:
        sys.argv = ["floria-tpu"]
        jax_cli.main(_inputs(base, out) + _ARGS[:-2])
    finally:
        sys.argv = argv
    want = _files(out)
    os.rename(out, str(tmp_path / "jax"))
    _spawn(base, out, 1)
    assert _files(out) == want
    os.rename(out, str(tmp_path / "one"))
    _spawn(base, out, 2)
    two = _files(out)
    shards = {f"contig_ploidy_info.{k}.tsv" for k in (0, 1)}
    assert set(two) == set(want) | shards
    assert {k: v for k, v in two.items() if k not in shards} == want
    assert all(os.path.join(n, f"{n}.vartigs") in want for n in names)


def test_two_process_contig_restriction(multihost_sim, tmp_path):
    """-G intersects each rank's shard: only the listed contigs are
    phased, wherever they were assigned; a rank left with none phases
    nothing."""
    base, names = multihost_sim
    for keep in (names[:3], names[:1]):
        out = str(tmp_path / f"restricted{len(keep)}")
        _spawn(base, out, 2, extra=["-G", *keep])
        for name in names:
            exists = os.path.exists(os.path.join(out, name,
                                                 f"{name}.vartigs"))
            assert exists == (name in keep), (keep, name)
        with open(os.path.join(out, "contig_ploidy_info.tsv")) as fh:
            rows = [ln.split("\t")[0] for ln in fh.read().splitlines()[1:]]
        assert rows == keep
