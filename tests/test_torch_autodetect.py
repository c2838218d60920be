"""The port's -e/-l pass (floria_tpu_torch/ingest/autodetect.py) on BAMs
written with the port's BAM writer: its native path (the C++ scanner and
CIGAR walk), its pure fallback (`native.get_lib` unavailable) and the
JAX package's `l_epsilon_auto_detect` give equal (l, epsilon) on every
case, and the pass counts the records the native scanner handed it as
`estimate_records` (0 on the fallback)."""

import numpy as np
import pytest
import torch

from floria_tpu.ingest.autodetect import \
    l_epsilon_auto_detect as jax_estimate
from floria_tpu_torch import constants, native, timing
from floria_tpu_torch.ingest import autodetect
from floria_tpu_torch.ingest import bam as bamlib
from floria_tpu_torch.sim import bamwrite
from floria_tpu_torch.sim.simulate import SimConfig, simulate

# One intra-op thread: the suite runs several pytest workers on one
# host, and oversubscribed OpenMP threads slow every worker down.
torch.set_num_threads(1)

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
CLEAN_FLAGS = (0, 16, 2048)
DROPPED_FLAGS = (4, 256, 512, 1024, 4 | 16, 256 | 2048, 1024 | 512)


class _Bam:
    """Records of a BAM being built: reads copy their contig's genome
    with substitutions at `err` on M/=/X ops; I and S bases are random."""

    def __init__(self, rng, lengths, err=0.12):
        self.rng = rng
        self.err = err
        self.refs = [(f"c{i}", n) for i, n in enumerate(lengths)]
        self.genomes = [_BASES[rng.integers(0, 4, n)] for n in lengths]
        self.records = []

    def read(self, tid, pos, cigar, flag=0, seq=None, err=None):
        rng = self.rng
        parts, r = [], pos
        for ln, op in cigar:
            if op in "M=X":
                b = self.genomes[tid][r:r + ln].copy()
                flip = rng.random(len(b)) < (self.err if err is None
                                              else err)
                b[flip] = _BASES[rng.integers(0, 4, int(flip.sum()))]
                parts.append(b)
            elif op in "IS":
                parts.append(_BASES[rng.integers(0, 4, ln)])
            if op in "M=XDN":
                r += ln
        if seq is None:
            seq = np.concatenate(parts).tobytes() if parts else b""
        rec = bamwrite.encode_record(f"r{len(self.records)}", flag, tid, pos,
                                     60, cigar, seq, [20] * len(seq))
        self.records.append(rec)
        return rec

    def tile(self, tid, lo, hi, depth, length, flag=0, err=None):
        """Reads of about `length` bp from lo to hi at about `depth`."""
        step = max(length // depth, 1)
        for start in range(lo, hi - 1, step):
            ln = int(self.rng.integers(length // 2, length * 3 // 2))
            ln = min(ln, hi - start)
            if ln > 0:
                self.read(tid, start, [(ln, "M")], flag, err=err)

    def write(self, path, shuffle=False):
        recs = list(self.records)
        if shuffle:
            self.rng.shuffle(recs)
        bamwrite.write_bam(path, self.refs, recs)


def _contigs(rng, path):
    """Contigs with records in no tid order, and tid -1 records. Most
    contigs are shorter than the stride, and each has reads of its own
    length and error rate, so where the stride carried over from the
    contigs before falls decides which of them are sampled."""
    lengths = [41_357] + [int(n) for n in rng.integers(600, 3_500, 14)]
    b = _Bam(rng, lengths)
    for tid, n in enumerate(lengths):
        b.tile(tid, 0, n, 8, min(400 + 300 * tid, n),
               err=0.02 + 0.01 * tid)
    for k in range(6):
        b.records.append(bamwrite.encode_record(
            f"u{k}", 4 if k % 2 else 0, -1, -1 if k % 2 else 500, 0,
            [(4_000, "M")] if k % 2 == 0 else [],
            b"ACGT" * 1_000, [20] * 4_000))
    b.write(path, shuffle=True)


def _flags(rng, path):
    """Unmapped, secondary, duplicate and qcfail records over the clean
    reads and over a stretch only they cover."""
    b = _Bam(rng, [60_000], err=0.08)
    b.tile(0, 0, 40_000, 7, 2_500)
    for k, flag in enumerate(DROPPED_FLAGS * 6):
        pos = int(rng.integers(0, 50_000))
        b.read(0, pos, [(9_000, "M")], flag,
               seq=_BASES[rng.integers(0, 4, 9_000)].tobytes())
    for k, flag in enumerate(CLEAN_FLAGS * 4):
        b.read(0, int(rng.integers(0, 38_000)), [(2_000, "M")], flag)
    b.write(path)


def _empty_seq(rng, path):
    """Records with an empty `seq` over the reads and beyond them."""
    b = _Bam(rng, [50_000])
    b.tile(0, 0, 30_000, 6, 2_000)
    for k in range(20):
        b.read(0, int(rng.integers(0, 45_000)), [(5_000, "M")], seq=b"")
    b.write(path)


def _cigars(rng, path):
    """CIGARs with I, D, N, S, H, = and X, and supplementary records
    with leading hard clips."""
    b = _Bam(rng, [80_000], err=0.1)
    shapes = ([(30, "S"), (900, "M"), (25, "I"), (400, "="), (60, "D"),
               (300, "X"), (1_500, "N"), (700, "M"), (12, "S")],
              [(100, "H"), (800, "M"), (3, "D"), (5, "I"), (1_200, "M"),
               (40, "H")],
              [(1_100, "="), (1, "X"), (2_000, "M"), (7, "N"), (500, "M")],
              [(2_000, "M"), (2_500, "D"), (600, "M")])
    for k in range(150):
        cig = shapes[k % len(shapes)]
        b.read(0, int(rng.integers(0, 74_000)), cig, 16 * (k % 2))
    for k in range(40):
        b.read(0, int(rng.integers(0, 74_000)),
               [(int(rng.integers(50, 3_000)), "H"), (2_400, "M"),
                (9, "S")], 2048)
    b.write(path)


def _zero_length(rng, path):
    """Reads that cover nothing (pos == end), touching reads and
    overlapping reads."""
    b = _Bam(rng, [40_000])
    pos = 0
    for k in range(30):           # back to back: each starts at the end
        ln = int(rng.integers(300, 1_700))   # of the one before
        for _ in range(6):
            b.read(0, pos, [(ln, "M")])
        pos += ln
    b.tile(0, 5_000, 25_000, 4, 3_000)
    for k in range(25):
        p = int(rng.integers(0, 39_000))
        b.read(0, p, [(int(rng.integers(1, 200)), "S")])
        b.read(0, p, [(30, "I"), (4, "S")])
    b.write(path)


def _deep(rng, path):
    """Deep enough to stop at 1000 error columns inside the second
    contig, whose read lengths grow along it; a third contig after."""
    b = _Bam(rng, [230_000, 1_100_000, 60_000], err=0.1)
    b.tile(0, 0, 230_000, 8, 12_000)
    start = 0
    while start < 1_100_000:
        ln = min(4_000 + start // 30, 1_100_000 - start)
        b.read(1, start, [(ln, "M")])
        start += max(ln // 8, 1)
    b.tile(2, 0, 60_000, 8, 30_000)
    b.write(path)


def _none_usable(rng, path):
    """Only records that the pass filters out."""
    b = _Bam(rng, [20_000])
    for k, flag in enumerate(DROPPED_FLAGS * 3):
        b.read(0, 1_000 * k % 15_000, [(3_000, "M")], flag)
    b.read(0, 100, [(3_000, "M")], seq=b"")
    b.write(path)


def _no_records(rng, path):
    bamwrite.write_bam(path, [("c0", 10_000)], [])


def _corrupt(rng, path):
    """Records with corrupt geometry among good ones: a CIGAR whose query
    length differs from the sequence's, an `l_seq` that overruns the
    record, and an op code past X."""
    b = _Bam(rng, [50_000])
    b.tile(0, 0, 50_000, 7, 3_000)
    for k in range(8):
        p = int(rng.integers(0, 40_000))
        b.read(0, p, [(9_000, "M")],
               seq=_BASES[rng.integers(0, 4, 8_990)].tobytes())
        rec = bytearray(b.read(0, p, [(9_000, "M")]))
        rec[20:24] = (9_500).to_bytes(4, "little")   # l_seq past the end
        b.records[-1] = bytes(rec)
        rec = bytearray(b.read(0, p, [(9_000, "M")]))
        off = 4 + 32 + rec[4 + 8]                     # the CIGAR's op
        rec[off] = (rec[off] & 0xF0) | 9
        b.records[-1] = bytes(rec)
    b.write(path, shuffle=True)


def _community(rng, path):
    """A small simulated community, split reads included."""
    out = path + ".sim"
    simulate(SimConfig(contig_len=60_000, num_strains=3, num_snps=400,
                       coverage_per_strain=10.0, read_length=5_000,
                       read_length_sd=900.0, error_rate=0.03,
                       supp_read_fraction=0.2, seed=17), out)
    return out + "/sim.bam"


CASES = {"contigs": _contigs, "flags": _flags, "empty_seq": _empty_seq,
         "cigars": _cigars, "zero_length": _zero_length, "deep": _deep,
         "none_usable": _none_usable, "no_records": _no_records,
         "corrupt": _corrupt, "community": _community}


def _bam(tmp_path, name):
    path = str(tmp_path / f"{name}.bam")
    return CASES[name](np.random.default_rng(20), path) or path


def _estimate(bam, monkeypatch=None):
    """(l, epsilon) and the `estimate_records` count of one pass; with
    `monkeypatch`, on the fallback."""
    if monkeypatch is not None:
        monkeypatch.setattr(native, "get_lib", lambda: None)
    with timing.span("cli.estimate") as sp:
        got = autodetect.l_epsilon_auto_detect(bam)
    return got, sp.counts.get("estimate_records")


@pytest.mark.parametrize("name", sorted(CASES))
def test_native_fallback_and_jax_estimates_agree(tmp_path, monkeypatch,
                                                 name):
    bam = _bam(tmp_path, name)
    want = jax_estimate(bam)
    got, counted = _estimate(bam)
    assert counted is not None and counted > 0 or name in (
        "none_usable", "no_records")
    assert got == want
    assert type(got[0]) is int and type(got[1]) is float
    fallback, counted = _estimate(bam, monkeypatch)
    assert counted == 0
    assert fallback == want
    if name in ("none_usable", "no_records"):
        assert want == (constants.MINIMUM_BLOCK_SIZE, 0.01)


def test_the_cases_reach_what_they_are_for(tmp_path):
    """The deep case stops on its second contig and the others stay
    short of the stop, so each case tests what it names."""
    stops = {}
    for name in ("deep", "contigs"):
        bam = _bam(tmp_path, name)
        fb = autodetect._open_native(bam)
        contigs, n_err = 0, 0
        for n_cols, col_idx, _b, _l in autodetect._native_contigs(fb):
            contigs += 1
            depth = np.bincount(col_idx, minlength=n_cols)
            n_err += int((depth >= 5).sum())
            if n_err >= 1000:
                break
        stops[name] = (contigs, n_err)
    assert stops["deep"][0] == 2 and stops["deep"][1] >= 1000
    assert stops["contigs"][0] > 3 and stops["contigs"][1] < 1000


@pytest.mark.parametrize("name", ["flags", "corrupt", "contigs",
                                  "none_usable"])
def test_estimate_records_counts_the_filtered_records(tmp_path,
                                                      monkeypatch, name):
    bam = _bam(tmp_path, name)
    want = sum(1 for tid, recs in
               bamlib.BamFile(bam).records_by_contig().items()
               if tid >= 0 for r in recs
               if not r.flag & (bamlib.ERRORS_MASK | bamlib.FLAG_SECONDARY)
               and len(r.seq))
    assert _estimate(bam)[1] == want
    assert _estimate(bam, monkeypatch)[1] == 0


def test_the_native_path_unpacks_no_read(tmp_path, monkeypatch):
    from floria_tpu_torch.ingest import fastingest

    def refuse(*_a, **_k):
        raise AssertionError("a read's sequence was unpacked")

    monkeypatch.setattr(fastingest.FastBam, "payloads_batch", refuse)
    monkeypatch.setattr(fastingest.FastBam, "payload", refuse)
    monkeypatch.setattr(bamlib, "_decode_seq", refuse)
    bam = _bam(tmp_path, "cigars")
    assert _estimate(bam)[0] == jax_estimate(bam)
