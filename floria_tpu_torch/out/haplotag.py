"""Haplotagging / BAM partitioning support shared by the ecosystem
scripts: parse haploset files, re-emit BAM records with HP:i tags.

Replaces the reference's pysam-based helpers (scripts/haplotag_bam.py,
scripts/get_bam_partition.py) using the framework's own BAM codec.
"""

from __future__ import annotations

import re
import struct
from typing import Dict, List, Set

from ..ingest import bgzf
from ..ingest.bam import BamFile, BamRecord

HAPQ_RE = re.compile(r"HAPQ:(\d+)")
INDEX_RE = re.compile(r"HAP(\d+)")


def read_haploset(path: str, min_hapq: int = 0) -> Dict[int, Set[str]]:
    """index -> read names, filtered by HAPQ."""
    parts: Dict[int, Set[str]] = {}
    good = False
    index = 0
    with open(path) as fh:
        for line in fh:
            if ">" in line:
                index = int(INDEX_RE.findall(line)[0])
                hapq = int(HAPQ_RE.findall(line)[0])
                good = hapq >= min_hapq
                if good:
                    parts[index] = set()
            elif good and line.strip():
                parts[index].add(line.split()[0])
    return parts


def record_with_hp_tag(record: BamRecord, hp: int) -> bytes:
    """Raw record body with an HP:i tag appended, block-size prefixed."""
    body = record.raw + b"HPi" + struct.pack("<i", hp)
    return struct.pack("<i", len(body)) + body


def record_passthrough(record: BamRecord) -> bytes:
    return struct.pack("<i", len(record.raw)) + record.raw


def write_bam_records(path: str, template: BamFile,
                      records: List[bytes]) -> None:
    """Write records with the template's header."""
    out = bytearray()
    out += b"BAM\x01"
    text = template.header_text.encode()
    out += struct.pack("<i", len(text)) + text
    out += struct.pack("<i", len(template.references))
    for name, length in zip(template.references, template.lengths):
        nb = name.encode() + b"\x00"
        out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
    for rec in records:
        out += rec
    with open(path, "wb") as fh:
        fh.write(bgzf.compress(bytes(out)))


def haplotag_records(bam: BamFile, contig: str,
                     name_to_part: Dict[str, int]) -> List[bytes]:
    out = []
    for rec in (bam.fetch(contig) if contig else bam.iter_records()):
        part = name_to_part.get(rec.qname)
        if part is not None:
            out.append(record_with_hp_tag(rec, part))
        else:
            out.append(record_passthrough(rec))
    return out
