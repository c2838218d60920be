"""The counts of `flush_pool` (floria_tpu_torch/kernels/realign.py) on
the CPU, with CPP_MAX_JOBS lowered so that partitions take the device NW
(`nw_best`, its plain version here): `realign_jobs` and `nw_left` in
`realign.host_prep`, and `nw_jobs`, `nw_alleles` and `h2d_bytes` in each
`realign.device.nw_best` span, equal what the precheck, the dedup and
`nw_best` were handed; every call equals the C++ Gotoh path's."""

import numpy as np
import pytest
import torch

from floria_tpu_torch import frag as torch_frag
from floria_tpu_torch import native as torch_native
from floria_tpu_torch import timing
from floria_tpu_torch.ingest import vcf as torch_vcf
from floria_tpu_torch.kernels import realign as TR
from test_torch_realign import _route_community, _route_frags

# One intra-op thread: the suite runs several pytest workers on one
# host, and oversubscribed OpenMP threads slow every worker down.
torch.set_num_threads(1)


def _flush(monkeypatch, cpp_max):
    """Realign the community with CPP_MAX_JOBS at `cpp_max` (None: as it
    is). Returns (frags, the flush's records, what the precheck, the
    dedup and each nw_best call were handed)."""
    ref, cv, reads = _route_community(vcf_cls=torch_vcf.ContigVcf)
    frags = _route_frags(cv, reads, torch_frag.Frag)
    seen = {"exact": [], "dedup": [], "nw_best": []}

    def kept(key, fn):
        def wrapped(*args):
            out = fn(*args)
            # flush_pool writes the NW's calls into the precheck's array.
            seen[key].append((args, out.copy() if key == "exact" else out))
            return out
        return wrapped

    monkeypatch.setattr(torch_native, "realign_exact",
                        kept("exact", torch_native.realign_exact))
    monkeypatch.setattr(torch_native, "dedup_jobs",
                        kept("dedup", torch_native.dedup_jobs))
    monkeypatch.setattr(TR, "nw_best", kept("nw_best", TR.nw_best))
    if cpp_max is not None:
        monkeypatch.setattr(TR, "CPP_MAX_JOBS", cpp_max)
    realigner = TR.SnpRealigner(ref, cv, TR.RealignPool())
    for f in frags:
        realigner.realign(f)
    with timing.span("test.flush") as root:
        realigner.flush("cpu")
    recs = [r for r in timing.records() if r.job == root.job]
    return frags, recs, seen


@pytest.mark.parametrize("cpp_max", [150, 0])
def test_nw_best_spans_count_the_jobs_alleles_and_bytes(monkeypatch,
                                                        cpp_max):
    # The C++ path's flush (every partition under CPP_MAX_JOBS) counts no
    # nw_best span.
    ref_frags, ref_recs, ref_seen = _flush(monkeypatch, None)
    assert not ref_seen["nw_best"]
    assert not [r for r in ref_recs if r.name == "realign.device.nw_best"]

    frags, recs, seen = _flush(monkeypatch, cpp_max)
    (prep,) = [r for r in recs if r.name == "realign.host_prep"]
    ((_q, si, nal, _var), exact), = seen["exact"]
    rest = np.nonzero(exact < 0)[0]
    assert prep.counts == {"realign_jobs": len(si), "nw_left": len(rest)}
    (_args, (uniq_local, _inv)), = seen["dedup"]
    bi = nal[rest[uniq_local]] <= 2
    # 150: the biallelic partition on nw_best, the rest on the C++
    # Gotoh; 0: both partitions on nw_best.
    want_jobs = [int(bi.sum())] + ([] if cpp_max else [int((~bi).sum())])
    assert all(want_jobs) and len(seen["nw_best"]) == len(want_jobs)
    spans = [r for r in recs if r.name == "realign.device.nw_best"]
    assert [r.counts["nw_jobs"] for r in spans] == want_jobs
    for k, (r, (args, _best)) in enumerate(zip(spans, seen["nw_best"])):
        jobs, tables, a_max = args[:3], args[3:5], args[5]
        nbytes = sum(x.numel() * x.element_size() for x in jobs)
        if k == 0:  # the tables go up once a flush
            nbytes += sum(x.numel() * x.element_size() for x in tables)
        assert r.counts == {
            "nw_jobs": len(jobs[0]),
            "nw_alleles": int(jobs[2].clamp(max=a_max).sum()),
            "h2d_bytes": nbytes}
    assert [f.seq_dict for f in frags] == [f.seq_dict for f in ref_frags]
    assert any(any(v for v in f.seq_dict.values()) for f in frags)
