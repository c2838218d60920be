"""The port held to the JAX package decision by decision, on the CPU: the
port's CLI (`--device cpu`, the plain path) on a North-star config with
its sweep, beam dispatches and climbs recorded (chip_smoke.py's
SweepRecorder, DispatchRecorder and ClimbRecorder), its outputs held to
the JAX CLI's hashes, and then four holds against the JAX functions on
JAX's CPU backend, each returning (instances compared, instances that
differ):

- the sweep, block by block: `floria_tpu.phase.local.adaptive_sweep` on
  the recorded blocks and Options, chosen ploidy, assignment (values and
  dtype), MEC and expected-error vectors bitwise (`jax_sweep_flips`);
- the beam, dispatch by dispatch: `_beam_search_batch_mixed_jit` +
  `traceback_batch` (tests/test_torch_beam.py `jax_beam_flips`);
- the climb, dispatch by dispatch: `_upem_optimize_device_jit`, best,
  mec and diff bitwise (`jax_climb_flips`);
- the fused level 2's ploidy-1 MEC: `_eval_mec` at ploidy 1 on the
  all-zero assignment, as the JAX chain computes it (`jax_mec1_flips`).

This file runs long2, long3, paired2, supp2 and fuzz seeds 5 and 19
and the holds' teeth; tests/test_torch_decisions_b.py and _c.py run the other
small configs and the sharded path, so that pytest-xdist's --dist
loadfile spreads them over workers.
tests/test_torch_cuda.py runs the same holds on the card.

Run as a script, it writes tests/data/sweep_golden.json, which
chip_smoke.py holds the card's sweeps to: per config (the 13 North-star
configs, bench.py's `ecoli2` and config #5's `multi500`) the sha256 of
the simulated inputs and, per contig, chip_smoke.block_digest of each
block's result of the JAX CLI's own sweep, in block order:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_decisions_a.py

It runs the JAX CLI on each config on the CPU, `ecoli2` and `multi500`
at full size (run it on a machine with cores and memory to spare; the
sandboxed test suite does not run it).
"""

import collections
import dataclasses
import json
import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from floria_tpu.kernels import realign as JR
from floria_tpu.kernels import upem_batch as JU
from floria_tpu.kernels.blocktensor import BlockTensor as JaxBlockTensor
from floria_tpu.options import Options as JaxOptions
from floria_tpu.phase import local as JL
from test_torch_beam import jax_beam_flips, pad_batch

# One intra-op thread: the suite runs several pytest workers on one
# host, and oversubscribed OpenMP threads slow every worker down.
torch.set_num_threads(1)

GOLDEN_SWEEP = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "data", "sweep_golden.json")
HOLDS = ("sweep", "beam", "climb")

Recording = collections.namedtuple("Recording",
                                   "sweeps beams climbs sim_dir")


def record_run(sim_dir, out_dir, device="cpu", extra=()):
    """The port's CLI on the inputs in `sim_dir`, its sweeps, beam
    dispatches and climbs recorded."""
    with chip_smoke.SweepRecorder() as sweeps, \
            chip_smoke.DispatchRecorder() as beams, \
            chip_smoke.ClimbRecorder() as climbs:
        chip_smoke.run_cli(sim_dir, out_dir, device=device, extra=extra)
    return Recording(sweeps.sweeps, beams.beam, climbs, sim_dir)


def record_config(name, tmp, device="cpu", extra=()):
    """record_run on a config of tests/data/north_star_golden.json (its
    flags, then `extra`), its inputs and outputs held to the golden
    record's hashes."""
    entry = chip_smoke.load_north_star()["configs"][name]
    sim_dir = os.path.join(tmp, name)
    out_dir = os.path.join(tmp, name + "_out")
    chip_smoke.simulate_case(entry, sim_dir)
    rec = record_run(sim_dir, out_dir, device,
                     [*chip_smoke.case_args(entry, sim_dir), *extra])
    chip_smoke.assert_golden_outputs(name, out_dir, entry["outputs_sha256"])
    return rec


def _same(a, b) -> bool:
    """Bitwise: dtype, shape and bytes."""
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def jax_blocks(blocks):
    """The port's [(key, BlockTensor)] as the JAX package's (the two
    classes are field-for-field copies)."""
    names = [f.name for f in dataclasses.fields(JaxBlockTensor)]
    return [(key, JaxBlockTensor(**{n: getattr(bt, n) for n in names}))
            for key, bt in blocks]


def jax_options(opts):
    names = [f.name for f in dataclasses.fields(JaxOptions)]
    return JaxOptions(**{n: getattr(opts, n) for n in names})


def jax_sweep_flips(sweeps):
    """Recorded sweeps (SweepRecorder.sweeps) against the JAX
    `adaptive_sweep` on the same blocks and Options, block by block.
    Returns (blocks compared, [(sweep, key)] whose chosen ploidy,
    assignment (values and dtype), MEC or expected-error vector
    differs). Grouping blocks into dispatches does not change a block's
    result (test_dispatch_cap_chunking_is_output_invariant)."""
    n, flips = 0, []
    for s, (blocks, opts, (chosen, mec, expected), _contigs) in enumerate(
            sweeps):
        w_chosen, w_mec, w_expected = JL.adaptive_sweep(jax_blocks(blocks),
                                                        jax_options(opts))
        assert set(w_chosen) == set(chosen) == {k for k, _bt in blocks}
        for key, _bt in blocks:
            n += 1
            (p, a), (wp, wa) = chosen[key], w_chosen[key]
            if not (p == wp and _same(a, wa) and _same(mec[key], w_mec[key])
                    and _same(expected[key], w_expected[key])):
                flips.append((s, key))
    return n, flips


def jax_batch(G):
    """The JAX sweep's batch for G instances (`floria_tpu.phase.local`
    `_sweep_launch`): a power of two, at least 8."""
    return max(8, 1 << max(0, G - 1).bit_length())


def jax_climb_flips(climbs, outputs):
    """Recorded climbs (ClimbRecorder.climbs and .outputs) against
    `_upem_optimize_device_jit` under x64, instance by instance, on the
    batch padded as the JAX sweep pads it (so the sweep hold's compiles
    serve). Returns (instances compared, [(climb, instance)] whose best
    [R], mec [2] or diff [R, P] (weight units) differ bitwise)."""
    n, flips = 0, []
    for d, ((P, (al, wt, nr, ep, asg0), A), got) in enumerate(
            zip(climbs, outputs, strict=True)):
        args = [t.cpu().numpy() for t in (al, wt, asg0, nr, ep)]
        G = len(args[0])
        with jax.enable_x64():
            ref = [np.asarray(x)[:G] for x in JU._upem_optimize_device_jit(
                *pad_batch(args, jax_batch(G)), P, A)]
        got = [t.cpu().numpy() for t in got]
        assert [a.dtype for a in got] == [a.dtype for a in ref]
        assert [a.shape for a in got] == [a.shape for a in ref]
        for g in range(G):
            n += 1
            if not all(_same(a[g], b[g]) for a, b in zip(ref, got)):
                flips.append((d, g))
    return n, flips


_eval_mec_jit = jax.jit(JU._eval_mec, static_argnums=(3, 4))


def jax_mec1_flips(mec1):
    """Recorded ploidy-1 MECs (ClimbRecorder.mec1: the fused level 2's)
    against `_eval_mec(alleles, zeros, eps, 1, A)` under x64, as the JAX
    chain computes them. Returns (instances compared, [(dispatch,
    instance)] whose [2] stats differ bitwise)."""
    n, flips = 0, []
    for d, (al, ep, A, got) in enumerate(mec1):
        al, ep = al.cpu().numpy(), ep.cpu().numpy()
        with jax.enable_x64():
            ref = np.asarray(_eval_mec_jit(
                al, jnp.zeros(al.shape[:2], jnp.int32), ep, 1, A))
        got = got.cpu().numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape
        for g in range(al.shape[0]):
            n += 1
            if not _same(ref[g], got[g]):
                flips.append((d, g))
    return n, flips


def jax_nw_flips(args, best, scores, chunk=1 << 15):
    """A device NW partition (chip_smoke.DispatchRecorder's `nw`: args =
    (q_packed, si, nal, ref_tab, al_tab, a_max)) against the JAX NW on
    the same packed inputs, job by job: the best allele against
    `_nw_best_chunked` (the jobs in chunks of `chunk`, the last padded
    with copies of the first job) and each allele's score ([N, a_max]
    int32, NEG at a >= nal) against `_nw_scores` on the allele's
    variant. Returns (jobs compared, [jobs whose best allele or any
    score differs])."""
    q, si, nal, ref_tab, al_tab = (t.cpu().numpy() for t in args[:5])
    a_max = args[5]
    best, scores = best.cpu().numpy(), scores.cpu().numpy()
    N = len(si)
    nal_tab = np.zeros(len(ref_tab), np.int32)
    nal_tab[si] = nal
    assert np.array_equal(nal_tab[si], nal)  # one allele count per SNP
    n_chunks = -(-N // chunk)
    qp, sp = pad_batch([q, si], n_chunks * chunk)
    want_best = np.asarray(JR._nw_best_chunked(
        qp.reshape(n_chunks, chunk, -1), sp.reshape(n_chunks, chunk),
        ref_tab, al_tab, nal_tab, a_max)).reshape(-1)[:N]
    assert best.dtype == want_best.dtype == np.int8
    codes = np.stack([qp & 0xF, qp >> 4], axis=-1).reshape(len(qp), -1)
    want_scores = np.empty((N, a_max), np.int32)
    for a in range(a_max):
        var = ref_tab[sp]
        var[:, JR.FLANK] = al_tab[sp, a]
        for lo in range(0, N, chunk):
            sc = np.asarray(JR._nw_scores(codes[lo:lo + chunk],
                                          var[lo:lo + chunk]))
            hi = min(N, lo + chunk)
            want_scores[lo:hi, a] = np.where(nal[lo:hi] > a,
                                             sc[:hi - lo], JR.NEG)
    assert scores.shape == want_scores.shape
    differ = (best != want_best) | (scores != want_scores).any(axis=1)
    return N, np.flatnonzero(differ).tolist()


def hold_counts(rec, holds=HOLDS):
    """{hold: (instances compared, differing)} of the holds on a
    recording; the climb's line also holds the ploidy-1 MECs."""
    out = {}
    if "sweep" in holds:
        out["sweep"] = jax_sweep_flips(rec.sweeps)
    if "beam" in holds:
        out["beam"] = jax_beam_flips(rec.beams)
    if "climb" in holds:
        out["climb"] = jax_climb_flips(rec.climbs.climbs,
                                       rec.climbs.outputs)
        out["mec1"] = jax_mec1_flips(rec.climbs.mec1)
    return out


def assert_holds(name, rec, holds=HOLDS):
    """Every hold compares at least one instance and none differs."""
    counts = hold_counts(rec, holds)
    summary = {h: [n, len(f)] for h, (n, f) in counts.items()}
    print(f"DECISIONS {name} " + json.dumps(summary))
    for h, (n, flips) in counts.items():
        assert n > 0 and flips == [], (name, h, flips[:20])
    return summary


@pytest.fixture(scope="module")
def recordings(tmp_path_factory):
    """One recorded port run per config, shared by its holds."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = record_config(
                name, str(tmp_path_factory.mktemp(name)))
        return cache[name]

    return get


CONFIGS = ["long2", "long3", "paired2", "supp2", "fuzz5", "fuzz19"]


@pytest.mark.parametrize("hold", HOLDS)
@pytest.mark.parametrize("name", CONFIGS)
def test_decisions_match_jax(name, hold, recordings):
    rec = recordings(name)
    assert rec.sweeps and rec.beams and rec.climbs.climbs
    assert len(rec.climbs.climbs) == len(rec.beams)
    assert_holds(name, rec, (hold,))


def _changed(arr, index):
    """A copy of `arr` (numpy or torch) with one element changed."""
    out = arr.clone() if isinstance(arr, torch.Tensor) else arr.copy()
    out[index] += 1
    return out


@pytest.mark.parametrize("what", ["ploidy", "assignment", "dtype", "mec",
                                  "expected"])
def test_sweep_hold_counts_one_changed_block(what, recordings):
    rec = recordings("long3")
    blocks, opts, (chosen, mec, expected), contigs = rec.sweeps[-1]
    key = blocks[-1][0]
    chosen, mec, expected = dict(chosen), dict(mec), dict(expected)
    p, a = chosen[key]
    if what == "ploidy":
        chosen[key] = (p + 1, a)
    elif what == "assignment":
        chosen[key] = (p, _changed(a, 0))
    elif what == "dtype":
        chosen[key] = (p, a.astype(np.int64))
    elif what == "mec":
        mec[key] = _changed(mec[key], 0)
    else:
        expected[key] = _changed(expected[key], p - 1)
    n, flips = jax_sweep_flips([(blocks, opts, (chosen, mec, expected),
                                 contigs)])
    assert n == len(blocks) and flips == [(0, key)]


@pytest.mark.parametrize("field", ["scores", "live"])
def test_beam_hold_counts_one_changed_instance(field, recordings):
    rec = recordings("long3")
    inputs, P, W, kw, (res, asg) = rec.beams[0]
    g = inputs[0].shape[0] // 2
    if field == "scores":
        res = res._replace(scores=_changed(res.scores, (g, 0)))
    else:
        live = res.live.clone()
        live[g, -1] = ~live[g, -1]
        res = res._replace(live=live)
    n, flips = jax_beam_flips([(inputs, P, W, kw, (res, asg))])
    assert n == inputs[0].shape[0] and flips == [(0, g)]


@pytest.mark.parametrize("what", ["best", "mec", "diff", "mec1"])
def test_climb_hold_counts_one_changed_instance(what, recordings):
    rec = recordings("long3")
    climbs = rec.climbs
    d = max(range(len(climbs.climbs)),
            key=lambda i: climbs.climbs[i][1][0].shape[0])
    if what == "mec1":
        al, ep, A, got = climbs.mec1[0]
        g = al.shape[0] - 1
        n, flips = jax_mec1_flips([(al, ep, A, _changed(got, (g, 1)))])
        assert n == al.shape[0] and flips == [(0, g)]
        return
    best, mec, diff = climbs.outputs[d]
    g = best.shape[0] - 1
    if what == "best":
        best = _changed(best, (g, 0))
    elif what == "mec":
        mec = _changed(mec, (g, 0))
    else:
        diff = _changed(diff, (g, 0, 1))
    n, flips = jax_climb_flips([climbs.climbs[d]], [(best, mec, diff)])
    assert n == best.shape[0] and flips == [(0, g)]


@pytest.mark.parametrize("A,a_max", [(2, 2), (4, 4)])
def test_nw_hold_on_the_plain_nw_counts_one_changed_job(A, a_max):
    """jax_nw_flips (hold (d), run at ecoli2's partition on the card) on
    the port's plain NW at adversarial windows (chip_smoke.nw_case):
    none differs; one changed best allele or one changed score is one
    differing job."""
    from floria_tpu_torch.kernels import realign as TR

    args = [torch.from_numpy(x) for x in chip_smoke.nw_case(
        n=3000, T=211, A=A, seed=A)] + [a_max]
    q, si, nal, ref_tab, al_tab = args[:5]
    scores = TR.nw_allele_scores_plain(*args)
    best = TR.nw_best_plain(*args)
    assert torch.equal(scores.argmax(dim=1).to(torch.int8), best)
    n, flips = jax_nw_flips(args, best, scores, chunk=1024)
    assert n == len(si) and flips == []
    assert jax_nw_flips(args, _changed(best, 7), scores, chunk=1024) == \
        (n, [7])
    assert jax_nw_flips(args, best, _changed(scores, (2999, a_max - 1)),
                        chunk=1024) == (n, [2999])


def test_smoke_decisions_hold_on_the_cpu(recordings):
    """chip_smoke.hold_decisions, the smoke's decisions phase, on long3's
    recorded sweep (the plain path): every block equal to
    tests/data/sweep_golden.json; one changed block digest fails it,
    counted as one."""
    rec = recordings("long3")
    got = chip_smoke.sweep_digests(rec.sweeps)
    res = chip_smoke.hold_decisions("long3", got, rec.sim_dir)
    assert res["blocks_compared"] == sum(map(len, got.values())) > 0
    assert res["blocks_differing"] == 0
    contig = sorted(got)[0]
    got[contig][-1] = "0" * 16
    with pytest.raises(AssertionError, match="1 of"):
        chip_smoke.hold_decisions("long3", got, rec.sim_dir)
    assert chip_smoke.DECISIONS[-1]["blocks_differing"] == 1


def test_block_digest_sees_every_field():
    """chip_smoke.block_digest, which the smoke compares with the golden
    record, changes with the ploidy, the assignment's values and dtype,
    and the MEC and expected-error vectors."""
    a = np.array([0, 1, 1, 0], np.int32)
    m, e = np.array([3.0, 1.5, 0.0]), np.array([2.0, 1.0, 0.0])
    base = chip_smoke.block_digest(2, a, m, e)
    for args in ((3, a, m, e), (2, _changed(a, 1), m, e),
                 (2, a.astype(np.int64), m, e), (2, a, _changed(m, 1), e),
                 (2, a, m, _changed(e, 2)), (2, a[:3], m, e)):
        assert chip_smoke.block_digest(*args) != base
    assert chip_smoke.block_digest(2, a.copy(), m.copy(), e.copy()) == base


def jax_golden_entry(sim_dir, out_dir, args):
    """One config's sweep_golden.json record: the inputs' sha256 and
    chip_smoke.sweep_digests of the JAX CLI's own sweeps (its
    floria_tpu.phase.local.adaptive_sweep calls) on the inputs in
    `sim_dir` with the CLI flags `args`."""
    from floria_tpu import cli as jax_cli
    from floria_tpu import pipeline as jax_pipeline

    with chip_smoke.SweepRecorder((JL, jax_pipeline, None)) as rec:
        jax_cli.main(["-b", os.path.join(sim_dir, "sim.bam"),
                      "-v", os.path.join(sim_dir, "sim.vcf"),
                      "-r", os.path.join(sim_dir, "sim.fa"),
                      "-o", out_dir, "--overwrite", *args])
    return {"inputs_sha256": chip_smoke.input_sha256(sim_dir),
            "contigs": chip_smoke.sweep_digests(rec.sweeps)}


def write_sweep_golden(path, names=None):
    """sweep_golden.json from the JAX package on the CPU: its simulator
    and CLI on each North-star config of north_star_golden.json (its
    inputs held to that record's hashes), on bench.py's `ecoli2` and on
    config #5's `multi500`."""
    from floria_tpu.sim.simulate import (SimConfig, simulate,
                                         simulate_hybrid, simulate_multi)

    from floria_tpu_torch.bench import _e2e_config
    from floria_tpu_torch.scripts import multihost_bench

    north_star = chip_smoke.load_north_star()["configs"]
    multi = f"multi{multihost_bench.CONTIGS}"
    names = names or [*north_star, "ecoli2", multi]
    record = {"configs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            sim_dir = os.path.join(tmp, name)
            args = []
            if name in north_star:
                entry = north_star[name]
                cfg = SimConfig(**entry["sim_config"])
                short = entry.get("short_coverage_per_strain")
                if short is None:
                    simulate(cfg, sim_dir)
                else:
                    simulate_hybrid(cfg, sim_dir,
                                    short_coverage_per_strain=short)
                args = chip_smoke.case_args(entry, sim_dir)
            elif name == "ecoli2":
                simulate(SimConfig(**dataclasses.asdict(
                    _e2e_config(False)[0])), sim_dir)
            else:
                simulate_multi([SimConfig(**dataclasses.asdict(c)) for c in
                                multihost_bench.multi_configs(
                                    multihost_bench.CONTIGS)], sim_dir)
            got = jax_golden_entry(sim_dir, os.path.join(tmp, name + "_out"),
                                   args)
            if name in north_star:
                for f, h in entry["inputs_sha256"].items():
                    assert got["inputs_sha256"][f] == h, (name, f)
            record["configs"][name] = got
            print(f"{name}: {sum(map(len, got['contigs'].values()))} "
                  f"blocks in {len(got['contigs'])} contigs",
                  file=sys.stderr, flush=True)
    with open(path, "w") as fh:
        json.dump(record, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(f"wrote {path}", file=sys.stderr)


if __name__ == "__main__":
    # python tests/test_torch_decisions_a.py [PATH [CONFIG ...]]
    write_sweep_golden(sys.argv[1] if len(sys.argv) > 1 else GOLDEN_SWEEP,
                       sys.argv[2:] or None)
