"""Synthetic strain-community generator.

Produces BAM + VCF + FASTA triples shaped like the reference's quick-start
workload (3-strain mock community, README.md:66-75): a reference contig,
K strain haplotypes differing at planted SNP sites, and error-bearing reads
sampled from the strains. Used by tests and by bench.py, since the
reference's binary fixtures are stripped from this snapshot.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ingest.fasta import write_fasta
from . import bamwrite

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclasses.dataclass
class SimConfig:
    contig_name: str = "sim_contig"
    contig_len: int = 100_000
    num_strains: int = 3
    num_snps: int = 300
    coverage_per_strain: float = 12.0
    read_length: int = 8_000
    read_length_sd: float = 1_500.0
    error_rate: float = 0.02
    base_qual: int = 20
    paired: bool = False
    insert_size: int = 400
    strain_abundances: Optional[Sequence[float]] = None
    # Fraction of long reads emitted as split reads: a primary alignment
    # plus a hard-clipped supplementary (flag 2048, MAPQ 60) downstream
    # of a simulated genomic deletion of supp_gap bp — exercises the
    # pair/supp merge path (file_reader.rs:185-235, 693-735) end to end.
    supp_read_fraction: float = 0.0
    supp_gap: int = 3_000
    # Explicit 0-based SNP genome positions (overrides num_snps'
    # uniform draw): lets tests plant the REAL spacing of the
    # reference's shipped Longshot VCF (tests/test.vcf — its BAM/FASTA
    # blobs are stripped from this snapshot, so simulated reads against
    # the true positions are the closest reachable workload).
    snp_positions: Optional[Sequence[int]] = None
    # Per-base qual jitter: quals drawn uniformly from
    # [base_qual - qual_jitter, base_qual + qual_jitter] (clipped to
    # [2, 41]) instead of the constant base_qual. Default 0 keeps every
    # existing seed's byte stream unchanged (the RNG is not consumed).
    # Non-uniform quals make -q/--use-qual-scores runs exercise
    # per-site fractional weights through scoring, dedup fingerprints
    # and UPEM (utils_frags.rs:14-31 derives weights from these).
    qual_jitter: int = 0
    seed: int = 7


@dataclasses.dataclass
class SimTruth:
    snp_positions: np.ndarray          # 0-based genome positions
    strain_alleles: np.ndarray         # [num_strains, num_snps] allele index
    read_strains: Dict[str, int]       # read id -> strain index


def _community(rng: np.random.Generator, cfg: SimConfig):
    """Reference + planted SNP truth + per-strain haplotype sequences."""
    ref = _BASES[rng.integers(0, 4, cfg.contig_len)]
    if cfg.snp_positions is not None:
        snp_pos = np.sort(np.asarray(cfg.snp_positions, dtype=np.int64))
        if (snp_pos[0] < 0 or snp_pos[-1] >= cfg.contig_len
                or len(np.unique(snp_pos)) != len(snp_pos)):
            raise ValueError("snp_positions out of range or duplicated")
        cfg.num_snps = len(snp_pos)
    else:
        snp_pos = np.sort(rng.choice(
            np.arange(50, cfg.contig_len - 50), size=cfg.num_snps,
            replace=False))

    # Each SNP is biallelic ref/alt; strains carry ref or alt so that at
    # least one strain differs (otherwise the site would not be in the VCF).
    shift = rng.integers(1, 4, cfg.num_snps)
    code_of = np.full(256, -1, np.int64)
    for i, b in enumerate(_BASES):
        code_of[b] = i
    alt = _BASES[(code_of[ref[snp_pos]] + shift) % 4]

    strain_alleles = rng.integers(0, 2, (cfg.num_strains, cfg.num_snps))
    # Force every site polymorphic across strains when possible.
    if cfg.num_strains > 1:
        mono = np.flatnonzero(strain_alleles.min(0) == strain_alleles.max(0))
        for j in mono:
            k = rng.integers(0, cfg.num_strains)
            strain_alleles[k, j] = 1 - strain_alleles[k, j]

    strains = []
    for k in range(cfg.num_strains):
        s = ref.copy()
        alt_sites = strain_alleles[k] == 1
        s[snp_pos[alt_sites]] = alt[alt_sites]
        strains.append(s)

    abund = (np.asarray(cfg.strain_abundances, dtype=float)
             if cfg.strain_abundances is not None
             else np.ones(cfg.num_strains))
    abund = abund / abund.sum()
    return ref, snp_pos, alt, strain_alleles, strains, abund


def _sample_reads(rng: np.random.Generator, cfg: SimConfig, strains,
                  abund, read_strains: Dict[str, int],
                  name_prefix: str = "") -> List[Tuple[int, bytes]]:
    """Sample a whole read library (long or paired per cfg.paired) from
    already-built strain sequences; returns (pos, encoded record) pairs."""
    total_bases = cfg.coverage_per_strain * cfg.num_strains * cfg.contig_len
    mean_frag = cfg.read_length if not cfg.paired else 2 * cfg.read_length
    num_reads = max(1, int(total_bases / mean_frag))
    records: List[Tuple[int, bytes]] = []
    for r in range(num_reads):
        k = int(rng.choice(cfg.num_strains, p=abund))
        if cfg.paired:
            _sim_pair(rng, cfg, strains[k], f"{name_prefix}{r}", k,
                      records, read_strains)
        else:
            _sim_long_read(rng, cfg, strains[k], f"{name_prefix}{r}", k,
                           records, read_strains)
    return records


def simulate(cfg: SimConfig, out_dir: str) -> SimTruth:
    rng = np.random.default_rng(cfg.seed)
    os.makedirs(out_dir, exist_ok=True)

    ref, snp_pos, alt, strain_alleles, strains, abund = _community(rng, cfg)

    read_strains: Dict[str, int] = {}
    records = _sample_reads(rng, cfg, strains, abund, read_strains)

    records.sort(key=lambda t: t[0])
    bam_path = os.path.join(out_dir, "sim.bam")
    bamwrite.write_bam(bam_path, [(cfg.contig_name, cfg.contig_len)],
                       [rec for _pos, rec in records])

    fasta_path = os.path.join(out_dir, "sim.fa")
    write_fasta(fasta_path, {cfg.contig_name: ref.tobytes()})

    vcf_path = os.path.join(out_dir, "sim.vcf")
    with open(vcf_path, "w") as vf:
        vf.write("##fileformat=VCFv4.2\n")
        vf.write(f"##contig=<ID={cfg.contig_name},length={cfg.contig_len}>\n")
        vf.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for j, p in enumerate(snp_pos):
            vf.write(f"{cfg.contig_name}\t{p + 1}\t.\t"
                     f"{chr(ref[p])}\t{chr(alt[j])}\t60\tPASS\t.\n")

    return SimTruth(snp_positions=snp_pos, strain_alleles=strain_alleles,
                    read_strains=read_strains)


def simulate_hybrid(cfg: SimConfig, out_dir: str,
                    short_coverage_per_strain: float = 20.0,
                    short_read_length: int = 150,
                    short_insert_size: int = 300,
                    short_error_rate: float = 0.002,
                    short_base_qual: int = 30) -> SimTruth:
    """Long-read sim.bam PLUS a paired short-read sim_short.bam sampled
    from the SAME community — the input shape of the reference's hybrid
    mode (`-H` second BAM, floria.rs:79-84): accurate short reads
    polish the long reads' SNP calls (utils_frags.rs:492-574) and are
    optionally re-attached to final haplogroups
    (part_block_manip.rs:235-270). Short pairs are named
    ``pair_h<idx>_s<strain>`` and included in the returned truth's
    read_strains."""
    rng = np.random.default_rng(cfg.seed)
    os.makedirs(out_dir, exist_ok=True)
    ref, snp_pos, alt, strain_alleles, strains, abund = _community(rng, cfg)

    read_strains: Dict[str, int] = {}
    long_records = _sample_reads(rng, cfg, strains, abund, read_strains)
    long_records.sort(key=lambda t: t[0])
    bamwrite.write_bam(os.path.join(out_dir, "sim.bam"),
                       [(cfg.contig_name, cfg.contig_len)],
                       [rec for _pos, rec in long_records])

    short_cfg = dataclasses.replace(
        cfg, paired=True, read_length=short_read_length,
        insert_size=short_insert_size, error_rate=short_error_rate,
        base_qual=short_base_qual,
        coverage_per_strain=short_coverage_per_strain)
    short_records = _sample_reads(
        np.random.default_rng(cfg.seed + 99991), short_cfg, strains,
        abund, read_strains, name_prefix="h")
    short_records.sort(key=lambda t: t[0])
    bamwrite.write_bam(os.path.join(out_dir, "sim_short.bam"),
                       [(cfg.contig_name, cfg.contig_len)],
                       [rec for _pos, rec in short_records])

    write_fasta(os.path.join(out_dir, "sim.fa"),
                {cfg.contig_name: ref.tobytes()})
    with open(os.path.join(out_dir, "sim.vcf"), "w") as vf:
        vf.write("##fileformat=VCFv4.2\n")
        vf.write(f"##contig=<ID={cfg.contig_name},length={cfg.contig_len}>\n")
        vf.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for j, p in enumerate(snp_pos):
            vf.write(f"{cfg.contig_name}\t{p + 1}\t.\t"
                     f"{chr(ref[p])}\t{chr(alt[j])}\t60\tPASS\t.\n")

    return SimTruth(snp_positions=snp_pos, strain_alleles=strain_alleles,
                    read_strains=read_strains)


def simulate_multi(cfgs: Sequence[SimConfig], out_dir: str
                   ) -> List[SimTruth]:
    """Simulate several contigs (each its own community with unique
    contig_name) and merge them into one coordinate-sorted
    sim.bam/sim.vcf/sim.fa under out_dir — a metagenome-shaped input
    for multi-contig tests and benchmarks."""
    import shutil
    import struct as _struct

    from ..ingest.bam import BamFile
    from ..ingest.fasta import FastaFile

    os.makedirs(out_dir, exist_ok=True)
    truths: List[SimTruth] = []
    refs: List[Tuple[str, int]] = []
    fastas: Dict[str, bytes] = {}
    vcf_body: List[str] = []
    records: List[Tuple[int, int, bytes]] = []
    for tid, cfg in enumerate(cfgs):
        sub = os.path.join(out_dir, f".sub{tid}")
        truths.append(simulate(cfg, sub))
        refs.append((cfg.contig_name, cfg.contig_len))
        bf = BamFile(os.path.join(sub, "sim.bam"))
        for rec in bf.fetch(cfg.contig_name):
            # next_refID / next_pos sit at raw offsets 20/24 (the raw
            # body starts at refID).
            nrid, npos = _struct.unpack_from("<ii", rec.raw, 20)
            cigar = [(int(ln), "MIDNSHP=X"[int(op)])
                     for op, ln in zip(*rec.cigar_ops())]
            records.append((tid, rec.pos, bamwrite.encode_record(
                rec.qname, rec.flag, tid, rec.pos, rec.mapq, cigar,
                rec.seq.tobytes(), list(rec.qual),
                next_tid=(tid if nrid >= 0 else -1), next_pos=npos,
                tlen=rec.tlen)))
        fastas[cfg.contig_name] = FastaFile(
            os.path.join(sub, "sim.fa")).fetch(cfg.contig_name)
        for line in open(os.path.join(sub, "sim.vcf")):
            if not line.startswith("#"):
                vcf_body.append(line)
        shutil.rmtree(sub)

    records.sort(key=lambda t: (t[0], t[1]))
    bamwrite.write_bam(os.path.join(out_dir, "sim.bam"), refs,
                       [r for _t, _p, r in records])
    write_fasta(os.path.join(out_dir, "sim.fa"), fastas)
    with open(os.path.join(out_dir, "sim.vcf"), "w") as vf:
        vf.write("##fileformat=VCFv4.2\n")
        for name, length in refs:
            vf.write(f"##contig=<ID={name},length={length}>\n")
        vf.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        vf.writelines(vcf_body)
    return truths


def _mutate(rng: np.random.Generator, seq: np.ndarray,
            error_rate: float) -> np.ndarray:
    """Substitution errors only (keeps CIGAR a single match op)."""
    if error_rate <= 0:
        return seq
    err = rng.random(len(seq)) < error_rate
    if not err.any():
        return seq
    out = seq.copy()
    code_of = np.zeros(256, np.int64)
    for i, b in enumerate(_BASES):
        code_of[b] = i
    shift = rng.integers(1, 4, int(err.sum()))
    out[err] = _BASES[(code_of[out[err]] + shift) % 4]
    return out


def _quals(rng, cfg: SimConfig, n: int):
    """Per-base phred quals. jitter==0 returns the constant list WITHOUT
    consuming rng, so pre-existing seeds reproduce byte-identically."""
    if cfg.qual_jitter <= 0:
        return [cfg.base_qual] * n
    lo = max(2, cfg.base_qual - cfg.qual_jitter)
    hi = min(41, cfg.base_qual + cfg.qual_jitter)
    return rng.integers(lo, hi + 1, n).tolist()


def _sim_long_read(rng, cfg: SimConfig, strain: np.ndarray, idx: int,
                   k: int, records, read_strains) -> None:
    ln = int(np.clip(rng.normal(cfg.read_length, cfg.read_length_sd),
                     200, cfg.contig_len))
    pos = int(rng.integers(0, max(1, cfg.contig_len - ln)))
    name = f"read_{idx}_s{k}"
    read_strains[name] = k
    if (cfg.supp_read_fraction > 0.0
            and rng.random() < cfg.supp_read_fraction
            and pos + ln + cfg.supp_gap < cfg.contig_len
            and ln >= 400):
        _sim_split_read(rng, cfg, strain, name, pos, ln, records)
        return
    seq = _mutate(rng, strain[pos:pos + ln], cfg.error_rate)
    qual = _quals(rng, cfg, len(seq))
    rec = bamwrite.encode_record(name, 0, 0, pos, 60,
                                 [(len(seq), "M")], seq.tobytes(), qual)
    records.append((pos, rec))


def _sim_split_read(rng, cfg: SimConfig, strain: np.ndarray, name: str,
                    pos: int, ln: int, records) -> None:
    """Emit a read spanning a supp_gap-bp genomic deletion as an aligner
    would: primary = first segment M + second soft-clipped (full seq),
    supplementary (flag 2048, MAPQ 60) = leading hard-clip + second
    segment M with only that segment's bases."""
    h1 = ln // 2
    h2 = ln - h1
    pos2 = pos + h1 + cfg.supp_gap
    seg1 = _mutate(rng, strain[pos:pos + h1], cfg.error_rate)
    seg2 = _mutate(rng, strain[pos2:pos2 + h2], cfg.error_rate)
    full = np.concatenate([seg1, seg2])
    qual = _quals(rng, cfg, ln)
    primary = bamwrite.encode_record(
        name, 0, 0, pos, 60, [(h1, "M"), (h2, "S")], full.tobytes(), qual)
    # The supplementary carries the SECOND segment's bases, so its quals
    # are qual[h1:] (identical to the old qual[:h2] when quals are
    # uniform; distinct — and aligner-faithful — under qual_jitter).
    supp = bamwrite.encode_record(
        name, 2048, 0, pos2, 60, [(h1, "H"), (h2, "M")], seg2.tobytes(),
        qual[h1:])
    records.append((pos, primary))
    records.append((pos2, supp))


def _sim_pair(rng, cfg: SimConfig, strain: np.ndarray, idx: int, k: int,
              records, read_strains) -> None:
    rl = cfg.read_length
    span = 2 * rl + cfg.insert_size
    pos = int(rng.integers(0, max(1, cfg.contig_len - span)))
    name = f"pair_{idx}_s{k}"
    read_strains[name] = k
    seq1 = _mutate(rng, strain[pos:pos + rl], cfg.error_rate)
    pos2 = pos + rl + cfg.insert_size
    seq2 = _mutate(rng, strain[pos2:pos2 + rl], cfg.error_rate)
    qual1 = _quals(rng, cfg, rl)
    qual2 = _quals(rng, cfg, rl)
    rec1 = bamwrite.encode_record(
        name, 1 | 64 | 32, 0, pos, 60, [(rl, "M")], seq1.tobytes(), qual1,
        next_tid=0, next_pos=pos2, tlen=span)
    rec2 = bamwrite.encode_record(
        name, 1 | 128 | 16, 0, pos2, 60, [(rl, "M")], seq2.tobytes(), qual2,
        next_tid=0, next_pos=pos, tlen=-span)
    records.append((pos, rec1))
    records.append((pos2, rec2))
