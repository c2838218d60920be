"""The port's realignment (floria_tpu_torch/kernels/realign.py) against
the JAX package on the CPU: the plain NW bitwise against `_nw_scores`,
`_nw_best_chunked` and the native C++ Gotoh (through the port's own
bridge, `floria_tpu_torch.native`), the partition route of `flush_pool`,
and the CLI with the device route forced on. Every comparison is exact:
NW scores are integers.

K5 (csrc/nw_best.cu) itself is held against the plain version on a card
by tests/test_torch_cuda.py and chip_smoke.py.
"""

import filecmp
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import floria_tpu.kernels.realign as R
from chip_smoke import nw_case
from floria_tpu import cli as jax_cli
from floria_tpu.frag import Frag
from floria_tpu.ingest.vcf import ContigVcf
from floria_tpu_torch import cli as torch_cli
from floria_tpu_torch import frag as torch_frag
from floria_tpu_torch import native as torch_native
from floria_tpu_torch.ingest import vcf as torch_vcf
from floria_tpu_torch.kernels import realign as TR
from floria_tpu_torch.sim.simulate import SimConfig, simulate

# One intra-op thread: the suite runs several pytest workers on one
# host, and oversubscribed OpenMP threads slow every worker down.
torch.set_num_threads(1)


def _unpack(q_packed):
    return np.stack([q_packed & 0xF, q_packed >> 4], axis=-1).reshape(
        len(q_packed), R.WINDOW)


def _pairs(kind, n=600, seed=0):
    """(q, r) [n, 32] code pairs of one adversarial kind."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, 16, (n, R.WINDOW)).astype(np.uint8)
    q = r.copy()
    if kind == "mismatches":
        for i in range(n):
            q[i, rng.integers(0, R.WINDOW, rng.integers(1, 6))] = \
                rng.integers(0, 16)
    elif kind == "shifts":
        for i in range(n):
            s = int(rng.integers(1, 17))
            q[i] = np.roll(r[i], s if i % 2 else -s)
    elif kind == "random":
        q = rng.integers(0, 16, (n, R.WINDOW)).astype(np.uint8)
    elif kind == "sentinel":
        # All-mismatch homopolymers and half-window shifts: the best
        # paths run through the longest gaps and the lowest scores.
        r[: n // 2] = 1
        q[: n // 2] = 2
        q[n // 2:] = np.concatenate(
            [rng.integers(0, 16, (n - n // 2, R.FLANK)).astype(np.uint8),
             r[n // 2:, :R.FLANK]], axis=1)
    return q, r


@pytest.mark.parametrize("kind", ["exact", "mismatches", "shifts", "random",
                                  "sentinel"])
def test_nw_scores_plain_matches_jax(kind):
    q, r = _pairs(kind)
    want = np.asarray(R._nw_scores(jnp.asarray(q), jnp.asarray(r)))
    got = TR.nw_scores_plain(torch.from_numpy(q), torch.from_numpy(r))
    # The reference's DP runs in int16, the port's in int32: equal
    # integers, as no value leaves int16's range.
    assert want.dtype == np.int16 and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want.astype(np.int32))
    if kind == "sentinel":
        assert got[: len(q) // 2].eq(-R.WINDOW).all()


def _jax_best(q_packed, si, ref_tab, al_tab, nal_tab, a_max):
    out = R._nw_best_chunked(jnp.asarray(q_packed[None]),
                             jnp.asarray(si[None]), jnp.asarray(ref_tab),
                             jnp.asarray(al_tab), jnp.asarray(nal_tab),
                             a_max)
    return np.asarray(out)[0]


@pytest.mark.parametrize("A,a_max", [(2, 2), (4, 4), (4, 2)])
def test_nw_best_plain_matches_jax_and_cpp(A, a_max):
    q_packed, si, nal, ref_tab, al_tab = nw_case(n=1500, T=97, A=A, seed=A)
    if a_max < A:  # the biallelic partition: jobs with nal <= a_max
        keep = nal <= a_max
        q_packed, si, nal = q_packed[keep], si[keep], nal[keep]
    assert set(nal.tolist()) == set(range(a_max + 1))
    nal_tab = np.zeros(len(ref_tab), np.int32)
    nal_tab[si] = nal
    t = [torch.from_numpy(x) for x in (q_packed, si, nal, ref_tab, al_tab)]
    got = TR.nw_best_plain(*t, a_max)
    assert got.dtype == torch.int8
    want = _jax_best(q_packed, si, ref_tab, al_tab, nal_tab, a_max)
    assert np.array_equal(got.numpy(), want)
    cpp = torch_native.nw_batch(q_packed, si, nal, ref_tab, al_tab)
    assert np.array_equal(got.numpy(), cpp)
    # The wrapper takes the plain version for CPU tensors.
    assert torch.equal(TR.nw_best(*t, a_max), got)
    # Scores: each allele against nw_scores_plain on the variant, NEG at
    # a >= nal; the best allele is their first maximum.
    sc = TR.nw_allele_scores_plain(*t, a_max)
    assert torch.equal(sc.argmax(dim=1).to(torch.int8), got)
    q = torch.from_numpy(_unpack(q_packed))
    for a in range(a_max):
        var = torch.from_numpy(ref_tab[si].copy())
        var[:, R.FLANK] = torch.from_numpy(al_tab[si, a])
        col = torch.where(torch.from_numpy(nal) > a,
                          TR.nw_scores_plain(q, var), R.NEG)
        assert torch.equal(sc[:, a], col)


def _route_community(seed=3, length=6000, n_reads=70, read_len=700,
                     vcf_cls=ContigVcf):
    """(ref bytes, `vcf_cls` table with some 3- and 4-allele sites,
    indel-rich reads) made from `seed`: most windows need the NW."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    ref = bases[rng.integers(0, 4, length)]
    pos = np.arange(60, length - 60, 29)
    pos_allele_map, pos_to_snp = {}, {}
    for k, p in enumerate(pos):
        others = [b for b in bases if b != ref[p]]
        n_alt = 1 + 2 * (k % 17 == 0) + (k % 34 == 0)
        alts = rng.permutation(others)[:n_alt]
        pos_allele_map[int(p)] = bytes([ref[p], *alts])
        pos_to_snp[int(p)] = k + 1
    cv = vcf_cls(genome_pos=pos.astype(np.int64),
                 pos_allele_map=pos_allele_map, pos_to_snp=pos_to_snp)
    reads = []
    for r in range(n_reads):
        s = int(rng.integers(0, length - read_len))
        seq, where = [], {}
        for g in range(s, s + read_len):
            u = rng.random()
            if u < 0.03:
                continue                               # deletion
            if u < 0.06:
                seq.append(int(bases[rng.integers(0, 4)]))  # insertion
            where[g] = len(seq)
            seq.append(int(ref[g]) if rng.random() > 0.04
                       else int(bases[rng.integers(0, 4)]))
        reads.append((f"r{r}", bytes(seq), where))
    return ref.tobytes(), cv, reads


def _route_frags(cv, reads, frag_cls=Frag):
    frags = []
    for counter, (name, seq, where) in enumerate(reads):
        f = frag_cls(name, counter, False)
        f.seq_string[0] = seq
        for g, k in cv.pos_to_snp.items():
            if g in where:
                f.add_site(k, 0, 30, 0, where[g])
        frags.append(f)
    return frags


def test_flush_pool_routes_partitions_as_the_reference(monkeypatch):
    ref, cv, reads = _route_community()
    want = _route_frags(cv, reads)
    jax_realigner = R.SnpRealigner(ref, cv, R.RealignPool())
    for f in want:
        jax_realigner.realign(f)
    R.flush_pool(jax_realigner.pool)

    calls = []

    def counted(name, fn):
        def wrapped(*args):
            calls.append((name, args))
            return fn(*args)
        return wrapped

    assert TR.native is torch_native
    monkeypatch.setattr(TR, "nw_best", counted("nw_best", TR.nw_best))
    monkeypatch.setattr(torch_native, "nw_batch",
                        counted("cpp", torch_native.nw_batch))
    monkeypatch.setattr(TR, "CPP_MAX_JOBS", 150)
    # The port's run on the port's own frag and VCF classes.
    _ref, cv_t, _reads = _route_community(vcf_cls=torch_vcf.ContigVcf)
    got = _route_frags(cv_t, reads, torch_frag.Frag)
    realigner = TR.SnpRealigner(ref, cv_t, TR.RealignPool())
    for f in got:
        realigner.realign(f)
    realigner.flush("cpu")

    assert [name for name, _ in calls] == ["nw_best", "cpp"]
    (_, dev_args), (_, cpp_args) = calls
    q, si, nal, ref_tab, al_tab, a_max = dev_args
    assert q.device.type == "cpu" and a_max == 2
    assert len(q) > TR.CPP_MAX_JOBS and nal.max() <= 2
    assert 0 < len(cpp_args[0]) <= TR.CPP_MAX_JOBS
    assert cpp_args[2].min() > 2
    assert al_tab.shape[1] == 4 and len(ref_tab) == cv.num_snps
    assert [f.seq_dict for f in got] == [f.seq_dict for f in want]
    assert any(any(v for v in f.seq_dict.values()) for f in got)


def _tree(root):
    out = []
    for d, _dirs, files in os.walk(root):
        for f in files:
            if f != "cmd.log":
                out.append(os.path.relpath(os.path.join(d, f), root))
    return sorted(out)


def test_cli_with_the_device_route_writes_the_jax_cli_bytes(tmp_path,
                                                           monkeypatch):
    sim_dir = str(tmp_path / "sim")
    simulate(SimConfig(contig_len=20_000, num_strains=2, num_snps=100,
                       coverage_per_strain=8.0, read_length=3_000,
                       read_length_sd=400.0, error_rate=0.04, seed=9),
             sim_dir)
    out_dir = str(tmp_path / "out")
    args = ["-b", os.path.join(sim_dir, "sim.bam"),
            "-v", os.path.join(sim_dir, "sim.vcf"),
            "-r", os.path.join(sim_dir, "sim.fa"), "-o", out_dir,
            "--overwrite", "-e", "0.04", "-l", "3000",
            "--snp-count-filter", "10"]
    jax_cli.main(args)
    shutil.move(out_dir, str(tmp_path / "jax"))

    sizes = []
    plain = TR.nw_best

    def counted(q, *rest):
        sizes.append(len(q))
        return plain(q, *rest)

    monkeypatch.setattr(TR, "nw_best", counted)
    monkeypatch.setattr(TR, "CPP_MAX_JOBS", 16)
    torch_cli.main(args + ["--device", "cpu"])
    assert sizes and min(sizes) > 16
    files = _tree(str(tmp_path / "jax"))
    assert files == _tree(out_dir)
    assert any(f.endswith(".vartigs") for f in files)
    for f in files:
        assert filecmp.cmp(os.path.join(str(tmp_path / "jax"), f),
                           os.path.join(out_dir, f), shallow=False), f
