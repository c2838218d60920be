"""The plain reference of one CLI run on a simulated community: the four
texts the CLI writes for the contig, from the raw BAM, VCF and FASTA.

It reads the files itself (BGZF with zlib, the BAM records with struct),
estimates -e and -l as floria does (file_reader.rs:749-826), projects the
reads onto the SNPs (file_reader.rs:661-736), realigns each (read, SNP)
site (alignment.rs:7-64: a 32 bp read window globally aligned against the
reference window with each allele at its centre, the first best allele
kept), and runs the post-ingest reference (`pipeline.py`). It covers what
the configurations' simulator writes: unpaired primary alignments of one
M operation; any other record raises.
"""

from __future__ import annotations

import gzip
import os
import struct
import types
from typing import Dict, List

import numpy as np

from . import phasing
from .pipeline import contig_texts, phase_contig, read_texts  # noqa: F401

_SEQ_CODES = np.frombuffer(b"=ACMGRSVTWYHKDBN", np.uint8)
FLANK = 16
NEG = -16384
MATCH, MISMATCH, GAP_OPEN, GAP_EXTEND = 1, -1, -2, -1
MINIMUM_BLOCK_SIZE = 500


def read_bam(path: str):
    """(contig name, contig length, records): each record a dict of
    name, flag, pos, mapq, cigar [(op, len)], seq (uint8 ASCII), qual."""
    with open(path, "rb") as fh:
        data = gzip.decompress(fh.read())
    if data[:4] != b"BAM\x01":
        raise ValueError(f"{path} is not a BAM file")
    (l_text,) = struct.unpack_from("<i", data, 4)
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    refs = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        name = data[off + 4:off + 4 + l_name - 1].decode()
        (l_ref,) = struct.unpack_from("<i", data, off + 4 + l_name)
        refs.append((name, l_ref))
        off += 8 + l_name
    if len(refs) != 1:
        raise ValueError("the reference covers one-contig BAMs only")
    records = []
    while off < len(data):
        (size,) = struct.unpack_from("<i", data, off)
        (ref_id, pos, l_name, mapq, _bin, n_cigar, flag, l_seq, _nr, _np,
         _tl) = struct.unpack_from("<iiBBHHHiiii", data, off + 4)
        p = off + 36
        name = data[p:p + l_name - 1].decode()
        p += l_name
        cig = struct.unpack_from(f"<{n_cigar}I", data, p)
        p += 4 * n_cigar
        packed = np.frombuffer(data, np.uint8, (l_seq + 1) // 2, p)
        p += (l_seq + 1) // 2
        codes = np.empty(2 * len(packed), np.uint8)
        codes[0::2] = packed >> 4
        codes[1::2] = packed & 15
        qual = np.frombuffer(data, np.uint8, l_seq, p)
        records.append({"name": name, "ref_id": ref_id, "flag": flag,
                        "pos": pos, "mapq": mapq,
                        "cigar": [(c & 15, c >> 4) for c in cig],
                        "seq": _SEQ_CODES[codes[:l_seq]], "qual": qual})
        off += 4 + size
    return refs[0][0], refs[0][1], records


def read_vcf(path: str, contig: str):
    """(0-based SNP positions, allele bytes [n, 2]) of the contig's
    biallelic single-base SNPs."""
    pos, alleles = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            if f[0] != contig:
                continue
            als = [f[3]] + f[4].split(",")
            if len(als) != 2 or any(len(a) != 1 or a.upper() not in "ACGT"
                                    for a in als):
                raise ValueError("the reference covers biallelic SNPs only")
            pos.append(int(f[1]) - 1)
            alleles.append([ord(a) for a in als])
    return np.array(pos, np.int64), np.array(alleles, np.uint8)


def read_fasta(path: str, contig: str) -> np.ndarray:
    seqs: Dict[str, List[bytes]] = {}
    name = None
    with open(path, "rb") as fh:
        for line in fh:
            line = line.rstrip(b"\r\n")
            if line.startswith(b">"):
                name = line[1:].split()[0].decode()
                seqs[name] = []
            elif name is not None:
                seqs[name].append(line)
    return np.frombuffer(b"".join(seqs[contig]).upper(), np.uint8)


def _check_records(records) -> None:
    for r in records:
        if (r["flag"] != 0 or r["ref_id"] != 0 or r["mapq"] < 15
                or len(r["cigar"]) != 1
                or r["cigar"][0][0] != 0 or r["cigar"][0][1] != len(r["seq"])):
            raise ValueError(f"record {r['name']}: only unpaired primary "
                             "alignments of one M operation are covered")


def estimate_l_epsilon(records):
    """floria's -l and -e estimates: every 1000th covered reference
    column; at each, the lengths of the covering reads and, where at
    least 5 reads cover it, the non-majority / majority base ratio;
    stop after 1000 error entries; -e is the 66th percentile error (at
    least 0.01), -l the 66th percentile read length (at least 500)."""
    events = sorted([(r["pos"], 1) for r in records]
                    + [(r["pos"] + len(r["seq"]), -1) for r in records])
    cols, covered, depth, prev = [], 0, 0, None
    for p, d in events:
        if prev is not None and depth > 0 and p > prev:
            n = p - prev
            first = (-covered) % 1000
            if first < n:
                cols.append(prev + np.arange(first, n, 1000))
            covered += n
        depth += d
        prev = p
    sampled = np.concatenate(cols) if cols else np.empty(0, np.int64)
    col_idx, bases, rlens = [], [], []
    for r in records:
        a = np.searchsorted(sampled, r["pos"])
        b = np.searchsorted(sampled, r["pos"] + len(r["seq"]))
        if b > a:
            col_idx.append(np.arange(a, b))
            bases.append(r["seq"][sampled[a:b] - r["pos"]])
            rlens.append(np.full(b - a, len(r["seq"])))
    if not col_idx:
        return MINIMUM_BLOCK_SIZE, 0.01
    col_idx = np.concatenate(col_idx)
    bases = np.concatenate(bases).astype(np.int64)
    rlens = np.concatenate(rlens)
    counts = np.bincount(col_idx * 256 + bases,
                         minlength=len(sampled) * 256).reshape(-1, 256)
    total = counts.sum(1).astype(np.float64)
    most = counts.max(1).astype(np.float64)
    err_cols = np.flatnonzero(total >= 5.0)
    errs = (total[err_cols] - most[err_cols]) / most[err_cols]
    if len(errs) >= 1000:
        cut = err_cols[999]
        errs = errs[:1000]
        rlens = rlens[col_idx <= cut]
    if not len(rlens):
        return MINIMUM_BLOCK_SIZE, 0.01
    rlens = np.sort(rlens)
    errs = np.sort(errs)
    q66 = int(rlens[len(rlens) * 66 // 100])
    med = float(errs[len(errs) * 66 // 100]) if len(errs) else 0.0
    return max(q66, MINIMUM_BLOCK_SIZE), max(med, 0.01)


def nw_scores(q: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Global affine-gap scores of equal-length byte windows q, r [N, W]:
    match +1, mismatch -1, a gap of k bases -2 - (k - 1); vertical gaps
    open from a match state only, horizontal ones from either."""
    N, W = q.shape
    j = np.arange(W + 1)
    m = np.broadcast_to(np.where(j == 0, 0, NEG), (N, W + 1)).astype(np.int64)
    iy = np.broadcast_to(
        np.where(j == 0, NEG, GAP_OPEN + GAP_EXTEND * (j - 1)),
        (N, W + 1)).astype(np.int64)
    ix = np.full((N, W + 1), NEG, np.int64)
    off = GAP_OPEN - GAP_EXTEND * (j + 1)
    for i in range(W):
        h = np.maximum(np.maximum(m, ix), iy)
        sub = np.where(q[:, i:i + 1] == r, MATCH, MISMATCH)
        m_new = np.full((N, W + 1), NEG, np.int64)
        m_new[:, 1:] = h[:, :-1] + sub
        ix = np.maximum(m + GAP_OPEN, ix + GAP_EXTEND)
        ix[:, 0] = GAP_OPEN + GAP_EXTEND * i
        cm = np.maximum.accumulate(np.maximum(m_new, ix) + off, axis=1)
        iy = np.full((N, W + 1), NEG, np.int64)
        iy[:, 1:] = cm[:, :-1] + GAP_EXTEND * j[1:]
        m = m_new
    return np.maximum(np.maximum(m[:, -1], ix[:, -1]), iy[:, -1])


def realign(queries: np.ndarray, refwin: np.ndarray,
            alleles: np.ndarray) -> np.ndarray:
    """The best allele (first of the highest score) of each site: queries
    [N, 32] read windows, refwin [N, 32] reference windows, alleles
    [N, A] allele bytes. A gapped alignment of two 32 bp windows scores
    at most 27 (at least one gap each way, two openings), an ungapped one
    32 - 2 * mismatches; so where some allele's window differs from the
    read's in at most two bases, the first such allele with the fewest
    mismatches wins. The other sites are aligned, each distinct problem
    once."""
    N, A = alleles.shape
    var = np.repeat(refwin[:, None, :], A, axis=1)
    var[:, :, FLANK] = alleles
    ham = (var != queries[:, None, :]).sum(-1)
    best = ham.argmin(1).astype(np.int8)
    rest = np.flatnonzero(ham.min(1) > 2)
    if len(rest):
        prob = np.concatenate(
            [queries[rest], var[rest].reshape(len(rest), -1)], axis=1)
        uniq, inv = np.unique(prob, axis=0, return_inverse=True)
        q = np.repeat(uniq[:, :2 * FLANK], A, axis=0)
        r = uniq[:, 2 * FLANK:].reshape(-1, 2 * FLANK)
        scores = nw_scores(q, r).reshape(-1, A)
        best[rest] = scores.argmax(1)[inv.reshape(-1)]
    return best


class Fragment(types.SimpleNamespace):
    """A read projected onto the SNPs: snps (1-based), alleles, quals and
    weights, its first and last SNP and its first and last base."""

    def sort_key(self):
        return (self.first_position, -self.last_position, self.counter_id)


def fragments(records, snp_pos, allele_bytes, ref):
    """The reads with at least one SNP, as fragments in floria's order
    (first SNP ascending, last SNP descending, record order) and
    renumbered: the read's base at each SNP it covers, kept where it is
    one of the SNP's alleles, then realigned where the 16 bp flanks lie
    inside the read and the contig."""
    frags = []
    for count, r in enumerate(records):
        seq, pos = r["seq"], r["pos"]
        a = np.searchsorted(snp_pos, pos)
        b = np.searchsorted(snp_pos, pos + len(seq))
        idx = np.arange(a, b)
        qpos = snp_pos[idx] - pos
        match = allele_bytes[idx] == seq[qpos][:, None]
        keep = match.any(1)
        idx, qpos = idx[keep], qpos[keep]
        calls = match[keep].argmax(1).astype(np.int8)
        gn = snp_pos[idx]
        ok = ((gn >= FLANK) & (gn + FLANK < len(ref)) & (qpos >= FLANK)
              & (qpos + FLANK < len(seq)))
        frags.append({"r": r, "count": count, "idx": idx, "qpos": qpos,
                      "calls": calls, "ok": ok})
    # Realign every site at once.
    win = np.arange(-FLANK, FLANK)
    q = np.concatenate([f["r"]["seq"][f["qpos"][f["ok"]][:, None] + win]
                        for f in frags] or [np.empty((0, 32), np.uint8)])
    si = np.concatenate([f["idx"][f["ok"]] for f in frags] or [
        np.empty(0, np.int64)])
    best = realign(q, ref[snp_pos[si][:, None] + win], allele_bytes[si])
    o = 0
    out = []
    for f in frags:
        n = int(f["ok"].sum())
        f["calls"][f["ok"]] = best[o:o + n]
        o += n
        if not len(f["idx"]):
            continue
        r = f["r"]
        quals = r["qual"][f["qpos"]]
        out.append(Fragment(
            id=r["name"], counter_id=f["count"], is_paired=False,
            snps=f["idx"].astype(np.int64) + 1, alleles=f["calls"],
            quals=quals, weights=phasing.phred_weight(quals),
            first_position=int(f["idx"][0]) + 1,
            last_position=int(f["idx"][-1]) + 1,
            first_pos_base=r["pos"], last_pos_base=r["pos"] + len(r["seq"])))
    out.sort(key=Fragment.sort_key)
    for i, f in enumerate(out):
        f.counter_id = i
    return out


def options_of(args: List[str], epsilon: float, block_length: int):
    """The run's options from the configuration's CLI arguments (the
    flags it uses) and the estimates; epsilon on the 2^-26 grid."""
    o = types.SimpleNamespace(
        max_ploidy=5, ploidy_sensitivity=2, max_number_solns=10,
        snp_density=0.0005, stopping_heuristic=True, reassign_short=False,
        epsilon=epsilon, block_length=block_length)
    flags = {"-p": ("max_ploidy", int), "-s": ("ploidy_sensitivity", int),
             "-n": ("max_number_solns", int), "-e": ("epsilon", float),
             "-l": ("block_length", int), "-d": ("snp_density", float)}
    it = iter(args)
    for a in it:
        if a not in flags:
            raise ValueError(f"CLI argument {a} is not covered")
        key, typ = flags[a]
        setattr(o, key, typ(next(it)))
    o.epsilon = phasing.epsilon_quanta(o.epsilon) / phasing.QUANTUM
    return o


def community_texts(sim_dir: str, config: dict, control: bool = False):
    """The four texts of the community in `sim_dir` (contig directory
    written as CDIR) and its sweep, [(block range, parts, MEC vector)];
    `control` phases in float32."""
    contig, length, records = read_bam(os.path.join(sim_dir, "sim.bam"))
    _check_records(records)
    snp_pos, allele_bytes = read_vcf(os.path.join(sim_dir, "sim.vcf"),
                                     contig)
    ref = read_fasta(os.path.join(sim_dir, "sim.fa"), contig)
    block_length, epsilon = estimate_l_epsilon(records)
    opts = options_of(config["cli"]["args"], epsilon, block_length)
    frags = fragments(records, snp_pos, allele_bytes, ref)
    sweep = []
    phased = phase_contig(frags, snp_pos, opts, control=control,
                          sweep=sweep)
    return contig_texts(phased, frags, snp_pos, contig, len(ref)), sweep
