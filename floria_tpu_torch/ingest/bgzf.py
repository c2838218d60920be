"""BGZF block-gzip codec.

The reference delegates BAM/BCF decoding to htslib's C BGZF layer
(file_reader.rs:12-16). This environment has no htslib binding, so we
implement the container format directly: BGZF is a sequence of gzip members,
each carrying a BC extra field with the compressed block size, terminated by
a fixed 28-byte EOF block. We decode by walking members with zlib; random
access via virtual offsets is unnecessary because ingest scans the full file
once and buckets records by contig.
"""

from __future__ import annotations

import struct
import zlib

# Canonical empty BGZF EOF marker block (SAM spec section 4.1.2).
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

_HEADER = struct.Struct("<4BI2BH")  # ID1 ID2 CM FLG MTIME XFL OS XLEN


def decompress(data: bytes) -> bytes:
    """Decompress an entire BGZF (or plain multi-member gzip) byte string."""
    out = []
    pos = 0
    n = len(data)
    while pos < n:
        d = zlib.decompressobj(wbits=31)
        out.append(d.decompress(data[pos:]))
        if not d.eof:
            raise ValueError("truncated BGZF stream")
        consumed = n - pos - len(d.unused_data)
        pos += consumed
    return b"".join(out)


def read_file(path: str) -> bytes:
    with open(path, "rb") as fh:
        raw = fh.read()
    if raw[:2] != b"\x1f\x8b":
        return raw  # uncompressed (e.g. SAM-adjacent text passthrough)
    try:
        from .. import native
        out = native.bgzf_inflate(raw)
        if out is not None:
            return out
    except Exception:  # pragma: no cover - native layer is optional
        pass
    return decompress(raw)


def read_file_array(path: str):
    """read_file returning a uint8 numpy array: the native inflate
    decodes straight into the array, skipping the whole-file bytes copy
    (~1 GB for a chromosome-scale BAM) — for consumers that only need a
    buffer (FastBam)."""
    import numpy as np

    with open(path, "rb") as fh:
        raw = fh.read()
    if raw[:2] != b"\x1f\x8b":
        return np.frombuffer(raw, np.uint8)
    try:
        from .. import native
        out = native.bgzf_inflate(raw, as_array=True)
        if out is not None:
            return out
    except Exception:  # pragma: no cover - native layer is optional
        pass
    return np.frombuffer(decompress(raw), np.uint8)


def compress_block(payload: bytes, level: int = 6) -> bytes:
    """Compress <=64KiB of payload into one BGZF member."""
    if len(payload) > 0xFF00:
        raise ValueError("BGZF payload exceeds 65280 bytes")
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = c.compress(payload) + c.flush()
    # Stored BSIZE = (total block length - 1); block = 12-byte header +
    # 6-byte extra field + deflate data + 8-byte footer.
    bsize = 12 + 6 + len(cdata) + 8 - 1
    header = _HEADER.pack(31, 139, 8, 4, 0, 0, 255, 6)
    extra = struct.pack("<2BHH", 66, 67, 2, bsize)
    footer = struct.pack("<II", zlib.crc32(payload), len(payload) & 0xFFFFFFFF)
    return header + extra + cdata + footer


def compress(payload: bytes, level: int = 6,
             block_size: int = 0xFF00) -> bytes:
    """Compress arbitrary payload as a BGZF stream with EOF marker."""
    blocks = []
    for off in range(0, len(payload), block_size):
        blocks.append(compress_block(payload[off:off + block_size], level))
    blocks.append(BGZF_EOF)
    return b"".join(blocks)
