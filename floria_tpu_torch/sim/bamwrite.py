"""Minimal BAM writer (for simulation and tests).

The reference ships binary BAM fixtures that were stripped from this
snapshot; we synthesize equivalent inputs instead, which requires emitting
standards-conforming BAM. Only the features the ingest path consumes are
produced: header with reference names/lengths, records with flags, MAPQ,
CIGAR, packed sequence, and raw quals.
"""

from __future__ import annotations

import struct
from typing import List, Sequence, Tuple

import numpy as np

from ..ingest import bgzf
from ..ingest.bam import SEQ_CODES

_CODE_OF = {c: i for i, c in enumerate(SEQ_CODES)}
_OP_OF = {c: i for i, c in enumerate("MIDNSHP=X")}
# 4-bit code of every byte value (case-insensitive, 15 = N otherwise).
_CODE_TABLE = np.array([_CODE_OF.get(chr(b).upper(), 15)
                        for b in range(256)], dtype=np.uint8)


def _pack_seq(seq: bytes) -> bytes:
    codes = _CODE_TABLE[np.frombuffer(bytes(seq), dtype=np.uint8)]
    if len(codes) % 2:
        codes = np.append(codes, np.uint8(0))
    return ((codes[0::2] << 4) | codes[1::2]).tobytes()


def encode_record(qname: str, flag: int, tid: int, pos: int, mapq: int,
                  cigar: Sequence[Tuple[int, str]], seq: bytes,
                  qual: Sequence[int], next_tid: int = -1,
                  next_pos: int = -1, tlen: int = 0) -> bytes:
    name = qname.encode() + b"\x00"
    cigar_bytes = b"".join(struct.pack("<I", (ln << 4) | _OP_OF[op])
                           for ln, op in cigar)
    packed = _pack_seq(seq)
    qual_bytes = bytes(qual) if qual else b"\xff" * len(seq)
    body = struct.pack("<iiBBHHHiiii", tid, pos, len(name), mapq, 0,
                       len(cigar), flag, len(seq), next_tid, next_pos, tlen)
    body += name + cigar_bytes + packed + qual_bytes
    return struct.pack("<i", len(body)) + body


def write_bam(path: str, references: List[Tuple[str, int]],
              records: List[bytes]) -> None:
    header_text = ("@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{name}\tLN:{length}\n" for name, length in references)
    ).encode()
    out = bytearray()
    out += b"BAM\x01"
    out += struct.pack("<i", len(header_text))
    out += header_text
    out += struct.pack("<i", len(references))
    for name, length in references:
        nb = name.encode() + b"\x00"
        out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
    for rec in records:
        out += rec
    with open(path, "wb") as fh:
        fh.write(bgzf.compress(bytes(out)))
