"""BAM container decode.

Replaces the reference's htslib-backed record access
(file_reader.rs:316-378). Parses the binary BAM layout (SAM spec section
4.2) into lightweight record objects. Ingest scans the whole file once and
buckets records by contig, so no .bai index is required (the reference needs
one only because it uses htslib's region fetch).

A C++ accelerator (native/) may be used for the BGZF+record scan when
available; this module is the always-available reference decoder.
"""

from __future__ import annotations

import logging
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from . import bgzf

log = logging.getLogger(__name__)

SEQ_CODES = "=ACMGRSVTWYHKDBN"
_SEQ_TABLE = np.frombuffer(SEQ_CODES.encode(), dtype=np.uint8)

# CIGAR op codes: MIDNSHP=X
CIGAR_OPS = "MIDNSHP=X"
_CONSUMES_QUERY = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1], dtype=bool)
_CONSUMES_REF = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=bool)

FLAG_PAIRED = 1
FLAG_UNMAPPED = 4
FLAG_REVERSE = 16
FLAG_FIRST_IN_PAIR = 64
FLAG_SECOND_IN_PAIR = 128
FLAG_SECONDARY = 256
FLAG_QCFAIL = 512
FLAG_DUP = 1024
FLAG_SUPPLEMENTARY = 2048

# unmapped | qcfail | dup | secondary — the reference's combined error mask
# (file_reader.rs:192 errors_mask = 1796 includes secondary).
ERRORS_MASK = 1796


class BamRecord:
    __slots__ = ("qname", "flag", "tid", "pos", "mapq", "cigar", "seq",
                 "qual", "tlen", "raw")

    def __init__(self, qname: str, flag: int, tid: int, pos: int, mapq: int,
                 cigar: np.ndarray, seq: np.ndarray, qual: np.ndarray,
                 tlen: int, raw: bytes = b""):
        self.qname = qname
        self.flag = flag
        self.tid = tid
        self.pos = pos  # 0-based leftmost reference position
        self.mapq = mapq
        self.cigar = cigar  # uint32 array: (oplen << 4) | op
        self.seq = seq      # uint8 ASCII bases
        self.qual = qual    # uint8 raw phred (no +33)
        self.tlen = tlen
        self.raw = raw      # full record body (without block_size prefix)

    def cigar_ops(self) -> Tuple[np.ndarray, np.ndarray]:
        return (self.cigar & 0xF).astype(np.int64), (self.cigar >> 4).astype(
            np.int64)

    def reference_end(self) -> int:
        """0-based exclusive end: pos + total reference-consuming length."""
        ops, lens = self.cigar_ops()
        return self.pos + int(lens[_CONSUMES_REF[ops]].sum())

    def leading_hardclips(self) -> int:
        if len(self.cigar) and (self.cigar[0] & 0xF) == 5:  # H
            return int(self.cigar[0] >> 4)
        return 0

    def infer_query_length(self) -> int:
        ops, lens = self.cigar_ops()
        return int(lens[_CONSUMES_QUERY[ops]].sum())


class BamFile:
    """Fully decoded BAM: header names + records grouped by contig."""

    def __init__(self, path: str):
        data = bgzf.read_file(path)
        if data[:4] != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file")
        l_text = struct.unpack_from("<i", data, 4)[0]
        off = 8 + l_text
        self.header_text = data[8:8 + l_text].rstrip(b"\x00").decode(
            errors="replace")
        n_ref = struct.unpack_from("<i", data, off)[0]
        off += 4
        self.references: List[str] = []
        self.lengths: List[int] = []
        for _ in range(n_ref):
            l_name = struct.unpack_from("<i", data, off)[0]
            name = data[off + 4:off + 4 + l_name - 1].decode()
            l_ref = struct.unpack_from("<i", data, off + 4 + l_name)[0]
            self.references.append(name)
            self.lengths.append(l_ref)
            off += 8 + l_name
        self._data = data
        self._records_start = off
        self._by_tid: Optional[Dict[int, List[BamRecord]]] = None

    def iter_records(self) -> Iterator[BamRecord]:
        data = self._data
        off = self._records_start
        n = len(data)
        skipped = 0
        unpack_core = struct.Struct("<iiiBBHHHiiii").unpack_from
        while off < n:
            if off + 36 > n:
                raise ValueError("malformed BAM: truncated record header")
            (block_size, tid, pos, l_read_name, mapq, _bin, n_cigar, flag,
             l_seq, _next_tid, _next_pos, tlen) = unpack_core(data, off)
            if block_size < 32 or off + 4 + block_size > n:
                raise ValueError("malformed BAM: record overruns file")
            # Corrupt geometry (fields overrun the record body, or the
            # CIGAR's query length disagrees with l_seq): reading on
            # would pull bytes from the wrong field and emit wrong
            # alleles silently — skip with a warning (htslib gives the
            # reference this validation; file_reader.rs:125,244 is its
            # loud-failure analog).
            need = 32 + l_read_name + 4 * n_cigar + (l_seq + 1) // 2 \
                + l_seq
            if need > block_size:
                skipped += 1
                off += 4 + block_size
                continue
            p = off + 36
            qname = data[p:p + l_read_name - 1].decode()
            p += l_read_name
            cigar = np.frombuffer(data, dtype="<u4", count=n_cigar,
                                  offset=p).astype(np.uint32)
            p += 4 * n_cigar
            if n_cigar and l_seq:
                ops = cigar & 0xF
                if (ops > 8).any():
                    skipped += 1
                    off += 4 + block_size
                    continue
                qlen = int((cigar >> 4)[_CONSUMES_QUERY[ops]].sum())
                if qlen != l_seq:
                    skipped += 1
                    off += 4 + block_size
                    continue
            nbytes = (l_seq + 1) // 2
            packed = np.frombuffer(data, dtype=np.uint8, count=nbytes,
                                   offset=p)
            seq = _decode_seq(packed, l_seq)
            p += nbytes
            qual = np.frombuffer(data, dtype=np.uint8, count=l_seq,
                                 offset=p).copy()
            raw = data[off + 4:off + 4 + block_size]
            off += 4 + block_size
            yield BamRecord(qname, flag, tid, pos, mapq, cigar, seq, qual,
                            tlen, raw)
        if skipped:
            log.warning("%d BAM record(s) with corrupt CIGAR/sequence "
                        "geometry skipped", skipped)

    def records_by_contig(self) -> Dict[int, List[BamRecord]]:
        if self._by_tid is None:
            by_tid: Dict[int, List[BamRecord]] = {}
            for rec in self.iter_records():
                by_tid.setdefault(rec.tid, []).append(rec)
            self._by_tid = by_tid
        return self._by_tid

    def fetch(self, contig: str) -> List[BamRecord]:
        """All records mapped to `contig`, in file order."""
        try:
            tid = self.references.index(contig)
        except ValueError:
            return []
        return self.records_by_contig().get(tid, [])


def _decode_seq(packed: np.ndarray, l_seq: int) -> np.ndarray:
    hi = packed >> 4
    lo = packed & 0xF
    codes = np.empty(2 * len(packed), dtype=np.uint8)
    codes[0::2] = hi
    codes[1::2] = lo
    return _SEQ_TABLE[codes[:l_seq]]


def read_header_references(path: str) -> List[str]:
    """Header target names without decoding the whole BAM: inflate BGZF
    members only until the reference list is complete (the header is in
    the first few members; a full-file inflate here would double the
    ingest's decompression cost)."""
    import zlib

    with open(path, "rb") as fh:
        raw = fh.read()
    if raw[:2] != b"\x1f\x8b":
        data = raw

        def more(_need: int) -> bool:
            return False
    else:
        chunks: List[bytes] = []
        pos = 0

        def more(need: int) -> bool:
            nonlocal pos, data
            while len(data) < need and pos < len(raw):
                # Feed <= 64 KiB slices until this member ends, counting
                # the bytes ACTUALLY fed (a fixed 64 KiB step would
                # overshoot when the member ends within the file's final
                # slice, jumping past later members).
                d = zlib.decompressobj(wbits=31)
                fed = 0
                while not d.eof and pos + fed < len(raw):
                    chunk = raw[pos + fed:pos + fed + (1 << 16)]
                    chunks.append(d.decompress(chunk))
                    fed += len(chunk)
                pos += fed - len(d.unused_data)
                data = b"".join(chunks)
            return len(data) >= need

        data = b""
        more(12)
    if data[:4] != b"BAM\x01":
        raise ValueError(f"{path}: not a BAM file")
    l_text = struct.unpack_from("<i", data, 4)[0]
    off = 8 + l_text
    more(off + 4)
    n_ref = struct.unpack_from("<i", data, off)[0]
    off += 4
    refs: List[str] = []
    for _ in range(n_ref):
        more(off + 4)
        l_name = struct.unpack_from("<i", data, off)[0]
        more(off + 8 + l_name)
        refs.append(data[off + 4:off + 4 + l_name - 1].decode())
        off += 8 + l_name
    return refs


def get_contigs_to_phase(bam_file: str) -> List[str]:
    """BAM header target names in order (file_reader.rs:738-746)."""
    return read_header_references(bam_file)


def aligned_snp_pairs(record: BamRecord,
                      snp_positions: np.ndarray) -> Tuple[np.ndarray,
                                                          np.ndarray]:
    """(query_pos, ref_pos) pairs at SNP sites covered by match ops.

    Equivalent to walking htslib aligned_pairs_full and keeping pairs where
    both sides are aligned and the reference side is a SNP
    (file_reader.rs:686-726); deletions at SNPs are skipped there too.
    `snp_positions` must be a sorted int64 array of 0-based genome positions.
    Returns query positions and reference positions (both 0-based).
    """
    ops, lens = record.cigar_ops()
    qpos_out = []
    rpos_out = []
    q = 0
    r = record.pos
    for op, ln in zip(ops, lens):
        ln = int(ln)
        if op in (0, 7, 8):  # M, =, X consume both
            lo = np.searchsorted(snp_positions, r)
            hi = np.searchsorted(snp_positions, r + ln)
            if hi > lo:
                hits = snp_positions[lo:hi]
                rpos_out.append(hits)
                qpos_out.append(hits - r + q)
            q += ln
            r += ln
        elif op in (1, 4):  # I, S consume query
            q += ln
        elif op in (2, 3):  # D, N consume reference
            r += ln
        # H, P consume neither
    if not rpos_out:
        empty = np.empty(0, dtype=np.int64)
        return empty, empty
    return np.concatenate(qpos_out), np.concatenate(rpos_out)
