"""Synthetic strain communities: BAM + VCF + FASTA made from a seed.

A frozen copy of the program's simulator (floria_tpu_torch/sim/
simulate.py `simulate`, sim/bamwrite.py, ingest/bgzf.py `compress` and
ingest/fasta.py `write_fasta`), cut to the long, unsplit, single-end reads
the configurations use: a random reference contig, K strains that differ
at planted biallelic SNPs (every site polymorphic across strains), and
reads drawn from the strains by abundance with normal lengths, uniform
starts, substitution errors only (one M operation per CIGAR), MAPQ 60 and
a constant base quality. The same configuration and seed give the same
bytes. The files hold the program's simulator's records, bases and
reference; the BGZF blocks are cut at the same offsets but deflated at
level 1, not 6, since a run makes its inputs in its set-up.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Tuple

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_SEQ_CODES = "=ACMGRSVTWYHKDBN"
_CODE_TABLE = np.array([_SEQ_CODES.find(chr(b).upper())
                        if chr(b).upper() in _SEQ_CODES else 15
                        for b in range(256)], dtype=np.uint8)
_BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000"
                          "000000000000")
_SUPPORTED = {"contig_name", "contig_len", "num_strains", "num_snps",
              "coverage_per_strain", "read_length", "read_length_sd",
              "error_rate", "base_qual", "seed"}


_CODE = np.full(256, -1, np.int64)
_CODE[_BASES] = np.arange(4)


def _community(rng, cfg):
    L = cfg["contig_len"]
    ref = _BASES[rng.integers(0, 4, L)]
    snp_pos = np.sort(rng.choice(np.arange(50, L - 50),
                                 size=cfg["num_snps"], replace=False))
    shift = rng.integers(1, 4, cfg["num_snps"])
    alt = _BASES[(_CODE[ref[snp_pos]] + shift) % 4]
    K = cfg["num_strains"]
    strain_alleles = rng.integers(0, 2, (K, cfg["num_snps"]))
    if K > 1:
        mono = np.flatnonzero(strain_alleles.min(0) == strain_alleles.max(0))
        for j in mono:
            k = rng.integers(0, K)
            strain_alleles[k, j] = 1 - strain_alleles[k, j]
    strains = []
    for k in range(K):
        s = ref.copy()
        sites = strain_alleles[k] == 1
        s[snp_pos[sites]] = alt[sites]
        strains.append(s)
    return ref, snp_pos, alt, strains, np.ones(K) / K


def _mutate(rng, seq, error_rate):
    if error_rate <= 0:
        return seq
    err = rng.random(len(seq)) < error_rate
    if not err.any():
        return seq
    out = seq.copy()
    shift = rng.integers(1, 4, int(err.sum()))
    out[err] = _BASES[(_CODE[out[err]] + shift) % 4]
    return out


def _pack_seq(seq: bytes) -> bytes:
    codes = _CODE_TABLE[np.frombuffer(bytes(seq), dtype=np.uint8)]
    if len(codes) % 2:
        codes = np.append(codes, np.uint8(0))
    return ((codes[0::2] << 4) | codes[1::2]).tobytes()


def _record(qname: str, pos: int, seq: bytes, qual: int) -> bytes:
    name = qname.encode() + b"\x00"
    cigar = struct.pack("<I", (len(seq) << 4) | 0)
    body = struct.pack("<iiBBHHHiiii", 0, pos, len(name), 60, 0, 1, 0,
                       len(seq), -1, -1, 0)
    body += name + cigar + _pack_seq(seq) + bytes([qual]) * len(seq)
    return struct.pack("<i", len(body)) + body


def _bgzf(payload: bytes) -> bytes:
    blocks = []
    for off in range(0, len(payload), 0xFF00):
        chunk = payload[off:off + 0xFF00]
        c = zlib.compressobj(1, zlib.DEFLATED, -15)
        cdata = c.compress(chunk) + c.flush()
        bsize = 12 + 6 + len(cdata) + 8 - 1
        blocks.append(struct.pack("<4BI2BH", 31, 139, 8, 4, 0, 0, 255, 6)
                      + struct.pack("<2BHH", 66, 67, 2, bsize) + cdata
                      + struct.pack("<II", zlib.crc32(chunk),
                                    len(chunk) & 0xFFFFFFFF))
    blocks.append(_BGZF_EOF)
    return b"".join(blocks)


def _write_bam(path: str, name: str, length: int,
               records: List[bytes]) -> None:
    header = (f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{name}\tLN:{length}\n"
              ).encode()
    nb = name.encode() + b"\x00"
    out = (b"BAM\x01" + struct.pack("<i", len(header)) + header
           + struct.pack("<i", 1) + struct.pack("<i", len(nb)) + nb
           + struct.pack("<i", length) + b"".join(records))
    with open(path, "wb") as fh:
        fh.write(_bgzf(out))


def simulate(cfg: dict, out_dir: str) -> int:
    """Write sim.bam, sim.vcf and sim.fa of the community `cfg` (the
    simulator's parameters) under out_dir; returns the number of reads."""
    unknown = set(cfg) - _SUPPORTED
    if unknown:
        raise ValueError(f"simulator parameters not supported: {unknown}")
    rng = np.random.default_rng(cfg["seed"])
    os.makedirs(out_dir, exist_ok=True)
    ref, snp_pos, alt, strains, abund = _community(rng, cfg)
    L, K = cfg["contig_len"], cfg["num_strains"]
    total = cfg["coverage_per_strain"] * K * L
    num_reads = max(1, int(total / cfg["read_length"]))
    records: List[Tuple[int, bytes]] = []
    for r in range(num_reads):
        k = int(rng.choice(K, p=abund))
        ln = int(np.clip(rng.normal(cfg["read_length"],
                                    cfg["read_length_sd"]), 200, L))
        pos = int(rng.integers(0, max(1, L - ln)))
        seq = _mutate(rng, strains[k][pos:pos + ln], cfg["error_rate"])
        records.append((pos, _record(f"read_{r}_s{k}", pos, seq.tobytes(),
                                     cfg["base_qual"])))
    records.sort(key=lambda t: t[0])
    name = cfg["contig_name"]
    _write_bam(os.path.join(out_dir, "sim.bam"), name, L,
               [rec for _pos, rec in records])
    with open(os.path.join(out_dir, "sim.fa"), "wb") as fh:
        fh.write(b">" + name.encode() + b"\n")
        seq = ref.tobytes()
        for off in range(0, len(seq), 80):
            fh.write(seq[off:off + 80] + b"\n")
    with open(os.path.join(out_dir, "sim.vcf"), "w") as vf:
        vf.write("##fileformat=VCFv4.2\n")
        vf.write(f"##contig=<ID={name},length={L}>\n")
        vf.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for j, p in enumerate(snp_pos):
            vf.write(f"{name}\t{p + 1}\t.\t{chr(ref[p])}\t{chr(alt[j])}"
                     f"\t60\tPASS\t.\n")
    return num_reads
