"""The port's oracle pipeline (`floria_tpu_torch.oracle`) on the CPU
against the JAX package's (tests/oracle.py, tests/oracle_pipeline.py):
the same partitions, ranges, HAPQs and relative errors, and the same
four output texts, on the oracle configs and hybrid; its beam search and
MEC on seeded random reads; the port's faithful C++ beam against its
own Python beam, read for read; the `use_native=False` path; no silent
fallback when the native library is missing; and the empty contig.

The inputs are simulated from tests/data/north_star_golden.json's
entries (their bytes held to the JAX simulator's hashes there).
"""

import math
import os
import types

import numpy as np
import pytest
import torch

import chip_smoke
import oracle as jax_oracle
import oracle_pipeline
from floria_tpu import fragops as jax_fragops
from floria_tpu.frag import sort_and_renumber as jax_sort_and_renumber
from floria_tpu.options import Options as JaxOptions
from floria_tpu_torch import native
from floria_tpu_torch import oracle as port_oracle
from floria_tpu_torch.bench import make_workload
from floria_tpu_torch.oracle import pipeline as port_pipeline
from floria_tpu_torch.oracle import reference
from floria_tpu_torch.options import Options
from floria_tpu_torch.out import writers
from floria_tpu_torch.scripts import oracle_e2e_baseline
from test_pipeline_oracle import _ingest_like_pipeline

# One intra-op thread: the suite runs several pytest workers on one
# host, and oversubscribed OpenMP threads slow every worker down.
torch.set_num_threads(1)

CONFIGS = ["long2", "long3", "paired2", "supp2", "hybrid"]


def oracle_kwargs(name, sim_dir):
    """Options fields of test_pipeline_oracle.py's runs of `name`."""
    kw = dict(bam_file=os.path.join(sim_dir, "sim.bam"),
              vcf_file=os.path.join(sim_dir, "sim.vcf"),
              reference_fasta=os.path.join(sim_dir, "sim.fa"),
              out_dir=os.path.join(sim_dir, "out"), epsilon=0.02,
              block_length=4000, snp_count_filter=10, overwrite=True)
    if name == "hybrid":
        kw.update(short_bam_file=os.path.join(sim_dir, "sim_short.bam"),
                  hybrid=True, reassign_short=True)
    return kw


def jax_oracle_run(opts, contig):
    """test_pipeline_oracle.py's oracle run (hybrid as its hybrid test
    builds it): (phased five-tuple, texts with the directory as CDIR,
    the number of long fragments)."""
    frags, _nosnp, cv = _ingest_like_pipeline(opts, contig)
    short = []
    if opts.hybrid:
        frags, short = jax_fragops.hybrid_correction(frags)
        frags = jax_sort_and_renumber(frags)
    combined = list(frags)
    for f in short:
        f.counter_id = len(combined)
        combined.append(f)
    phased = oracle_pipeline.phase_contig(frags, cv.genome_pos, opts,
                                          short_frags=short)
    parts, ranges, hapqs, rel, avg_err = phased
    gp, cdir = cv.genome_pos, port_pipeline.CDIR
    with open(opts.reference_fasta) as fh:
        contig_len = sum(len(ln.strip()) for ln in fh
                         if not ln.startswith(">"))
    texts = {
        "vartigs": oracle_pipeline.vartigs_text(
            parts, ranges, cdir, contig, combined, gp, hapqs, rel),
        "haplosets": oracle_pipeline.haplosets_text(
            parts, ranges, cdir, contig, combined, gp, hapqs, rel),
        "info": oracle_pipeline.vartig_info_text(parts, ranges, cdir,
                                                 combined, gp),
        "ploidy": oracle_pipeline.ploidy_row(parts, ranges, contig,
                                             combined, gp, hapqs, avg_err,
                                             contig_len)}
    return phased, texts, len(frags)


def _simulate(name, tmp_path):
    entry = chip_smoke.load_north_star()["configs"][name]
    sim_dir = str(tmp_path / "sim")
    chip_smoke.simulate_case(entry, sim_dir)
    return sim_dir, entry["sim_config"]["contig_name"]


@pytest.mark.parametrize("name", CONFIGS)
def test_port_oracle_matches_jax_oracle(name, tmp_path):
    """Partitions, ranges, HAPQs, relative and average errors equal, and
    the vartigs, haplosets, vartig_info and ploidy row texts equal byte
    for byte."""
    sim_dir, contig = _simulate(name, tmp_path)
    kw = oracle_kwargs(name, sim_dir)
    texts, phased, _seconds = port_oracle.run_contig(Options(**kw), contig,
                                                     device="cpu")
    want_phased, want_texts, n_long = jax_oracle_run(JaxOptions(**kw),
                                                     contig)
    assert phased[0] and phased[:4] == want_phased[:4]
    assert phased[4] == want_phased[4]
    assert texts == want_texts
    # Hybrid: short reads (ids after the long ones) re-attached, or the
    # hybrid path proves nothing.
    assert any(i >= n_long for p in phased[0] for i in p) == (
        name == "hybrid")


def _workload_reads(alleles, weights, g):
    """tests/test_native.py's reads of block g (snp -> (allele, w))."""
    reads = []
    for r in range(alleles.shape[1]):
        cols = np.nonzero(alleles[g, r] >= 0)[0]
        reads.append({int(c): (int(alleles[g, r, c]),
                               float(weights[g, r, c])) for c in cols})
    return reads


def _deep_coverage(ploidy):
    """tests/test_native.py:98's block: 600 reads on 8 SNPs, mixed
    phred weights, full-precision epsilon, canonical read order."""
    rng = np.random.default_rng(1234 + ploidy)
    R, S = 600, 8
    alleles = np.full((1, R, S), -1, dtype=np.int8)
    weights = np.zeros((1, R, S), dtype=np.float32)
    truth = rng.integers(0, 2, (3, S))
    for r in range(R):
        k = r % 3
        span = sorted(rng.choice(S, size=int(rng.integers(2, S + 1)),
                                 replace=False))
        lo, hi = span[0], span[-1]
        for c in range(lo, hi + 1):
            a = int(truth[k, c])
            if rng.random() < 0.03:
                a = 1 - a
            alleles[0, r, c] = a
            q = int(rng.integers(13, 41))
            weights[0, r, c] = np.float32(
                1.0 - np.float32(10.0) ** (np.float32(q) /
                                           np.float32(-10.0)))
    first = np.argmax(alleles[0] >= 0, axis=1)
    last = S - 1 - np.argmax(alleles[0, :, ::-1] >= 0, axis=1)
    order = np.lexsort((np.arange(R), -last, first))
    alleles[0] = alleles[0][order]
    weights[0] = weights[0][order]
    return alleles, weights


# tests/test_native.py's cases: (label, alleles and weights, ploidy, beam
# width, epsilon). `workload` is :52 (make_workload(2, 48, 96) at three
# seeds), `deep` is :98 and `dense` is :116's block set.
BEAM_CASES = {
    **{f"workload P={p} seed={s}": (lambda s=s: make_workload(
        2, 48, 96, seed=s)[:2], p, 10, 0.02)
       for p, s in ((2, 0), (3, 1), (4, 2))},
    **{f"deep P={p} W={w}": (lambda p=p: _deep_coverage(p), p, w,
                             0.029343605990619144)
       for p, w in ((3, 13), (4, 7))},
    "dense P=3 seed=3": (lambda: make_workload(2, 48, 96, seed=3)[:2], 3,
                         10, 0.02),
}


@pytest.fixture(scope="module")
def port_beams():
    """{case: (alleles, weights, [(reads, the port's beam assignment)
    per block])}, computed once for both beam tests."""
    out = {}
    for label, (make, P, W, eps) in BEAM_CASES.items():
        alleles, weights = make()
        blocks = []
        for g in range(alleles.shape[0]):
            reads = _workload_reads(alleles, weights, g)
            blocks.append((reads, reference.beam_search(reads, P, eps,
                                                        beam_width=W)))
        out[label] = (alleles, weights, blocks)
    return out


@pytest.mark.parametrize("case", sorted(BEAM_CASES))
def test_beam_search_and_mec_match_jax_oracle(case, port_beams):
    """reference.beam_search's assignment and mec_stats_epsilon's
    (bases, errors) per part, weighted and unit, equal to tests/oracle.py's
    on every block."""
    _make, P, W, eps = BEAM_CASES[case]
    _al, _wt, blocks = port_beams[case]
    for reads, got in blocks:
        assert got == jax_oracle.beam_search(reads, P, eps, beam_width=W)
        assert len(set(got)) > 1
        for weighted in (True, False):
            haps = reference.hap_from_partition(reads, got, P, weighted)
            assert haps == jax_oracle.hap_from_partition(reads, got, P,
                                                         weighted)
            assert reference.mec_stats_epsilon(haps, eps) == \
                jax_oracle.mec_stats_epsilon(haps, eps)


@pytest.mark.parametrize("case", sorted(BEAM_CASES))
def test_native_faithful_beam_matches_port_beam(case, port_beams):
    """The port's native.baseline_sweep(faithful=True) reproduces the
    port's Python beam read for read."""
    _make, P, W, eps = BEAM_CASES[case]
    alleles, weights, blocks = port_beams[case]
    asg = native.baseline_sweep(alleles, weights, [P], W, eps,
                                faithful=True, want_assign=True)
    for g, (_reads, want) in enumerate(blocks):
        assert list(asg[g]) == want, (case, g)


def test_python_beam_path_matches_native_path(tmp_path):
    """use_native=False (reference.beam_search in every block) phases
    long2 as the native beam does."""
    sim_dir, contig = _simulate("long2", tmp_path)
    opts = Options(**oracle_kwargs("long2", sim_dir))
    texts, phased, _s = port_oracle.run_contig(opts, contig, device="cpu")
    py_texts, py_phased, _s = port_oracle.run_contig(
        opts, contig, device="cpu", use_native=False)
    assert py_phased[:4] == phased[:4] and py_texts == texts


def test_missing_native_library_fails_rather_than_falls_back(
        tmp_path, monkeypatch):
    """When the native library cannot be built, the oracle's beam and the
    e2e script raise instead of running the Python beam."""
    def no_library():
        raise RuntimeError("native library unavailable")

    monkeypatch.setattr(native, "get_lib", no_library)
    monkeypatch.setattr(reference, "beam_search", lambda *a, **k: pytest.fail(
        "fell back to the Python beam"))
    al, wt, _nr, _eps = make_workload(1, 12, 16)
    cols = [np.nonzero(a >= 0)[0] for a in al[0]]
    reads = [types.SimpleNamespace(
        first_position=int(c[0]), last_position=int(c[-1]), snps=c,
        alleles=a[c], weights=w[c]) for a, w, c in zip(al[0], wt[0], cols)]
    with pytest.raises(RuntimeError, match="unavailable"):
        port_pipeline._beam_assign(reads, None, 2, 0.02, 10, True)
    with pytest.raises(RuntimeError, match="unavailable"):
        oracle_e2e_baseline.measure(str(tmp_path), "none")
    assert not (tmp_path / "oracle_out").exists()


def test_empty_contig_gives_the_pipelines_empty_outputs(tmp_path):
    """No block with reads: phase_contig returns a five-tuple (the JAX
    oracle returns four values there, which every caller unpacks as
    five), and its texts are what the pipeline's writers write for a
    contig without results: empty files and a ploidy row with a NaN
    error."""
    gp = np.array([100, 900, 2500, 4000], dtype=np.int64)
    opts = Options(out_dir=str(tmp_path), block_length=4000)
    phased = port_pipeline.phase_contig([], gp, opts)
    assert len(phased) == 5 and phased[:4] == ([], [], [], [])
    assert math.isnan(phased[4])
    texts = port_pipeline.contig_texts(phased, [], gp, "c1", 5000)
    writers.write_outputs([], [], str(tmp_path / "c1"), "c1", [], gp, opts,
                          [], 5000)
    assert port_pipeline.read_texts(str(tmp_path), "c1") == texts
    assert texts["vartigs"] == texts["haplosets"] == texts["info"] == ""
    assert texts["ploidy"].rstrip("\n").endswith("\tnan")


def test_written_texts_read_back_in_the_clis_layout(tmp_path):
    """write_texts puts each text where the CLI writes it, the contig
    directory in place of CDIR, and read_texts gives them back."""
    texts = {"vartigs": f">HAP0.{port_pipeline.CDIR}\tCONTIG:c\n01\n",
             "haplosets": f">HAP0.{port_pipeline.CDIR}\nr1\t1\t2\n",
             "info": "", "ploidy": "c\t1.000\n"}
    port_pipeline.write_texts(texts, str(tmp_path), "c")
    cdir = str(tmp_path / "c")
    assert (tmp_path / "c" / "c.vartigs").read_text() == \
        f">HAP0.{cdir}\tCONTIG:c\n01\n"
    assert sorted(os.listdir(tmp_path)) == ["c", "contig_ploidy_info.tsv"]
    assert port_pipeline.read_texts(str(tmp_path), "c") == texts
    assert port_pipeline.read_texts(str(tmp_path), "other") == dict.fromkeys(
        texts)


def test_smoke_oracle_phase_holds_the_cli_on_the_cpu(tmp_path):
    """chip_smoke.py's `oracle` phase (a) on the CPU: the port's CLI on
    long3 and hybrid (the north_star phase's run, plain path), then the
    oracle held to its texts and to tests/data/long3_oracle.json."""
    golden = chip_smoke.load_north_star()["configs"]
    dirs = {}
    for name in ("long3", "hybrid"):
        _rec, sim_dir, out_dir, _truth = chip_smoke.run_golden_case(
            name, golden[name], str(tmp_path), device="cpu")
        dirs[name] = (sim_dir, out_dir)
    chip_smoke.hold_oracle_configs(str(tmp_path), dirs, names=sorted(dirs))
    # A differing text fails the phase.
    cdir = os.path.join(dirs["long3"][1], "sim_contig")
    with open(os.path.join(cdir, "vartig_info.txt"), "a") as fh:
        fh.write("x")
    with pytest.raises(AssertionError, match=r"long3 \['info'\]"):
        chip_smoke.hold_oracle_configs(str(tmp_path), dirs, names=["long3"])


def test_smoke_quick2_baseline_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's `oracle` phase (b) with the port's run on the CPU:
    bench.measure_baseline_e2e's real subprocess on quick2 into a record
    under tmp_path, its texts equal to pipeline.run's with the bench's
    Options, no CUDA initialised in the child."""
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    monkeypatch.setattr(chip_smoke, "CARD", card)
    monkeypatch.setattr(chip_smoke.bench, "nvidia_smi_line", lambda: card)
    entry = chip_smoke.oracle_baseline_quick2(str(tmp_path), device="cpu")
    assert entry["card"] == card and entry["baseline_e2e_reads"] > 0
    assert sorted(os.listdir(tmp_path)) == ["BASELINE_E2E.json", "quick2"]
