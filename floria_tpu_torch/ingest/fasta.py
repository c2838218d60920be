"""FASTA access with .fai indexing.

The reference uses bio's IndexedReader and shells out to `samtools faidx`
when the index is missing (file_reader.rs:464-489). We read the FASTA
directly and write the .fai ourselves when absent — no external process.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple


class FastaFile:
    def __init__(self, path: str):
        self.path = path
        self._seqs: Dict[str, bytes] = {}
        self._order: List[str] = []
        self._load()
        fai = path + ".fai"
        if not os.path.exists(fai):
            try:
                self.write_fai(fai)
            except OSError:
                pass

    def _load(self) -> None:
        name = None
        chunks: List[bytes] = []
        with open(self.path, "rb") as fh:
            for line in fh:
                line = line.rstrip(b"\r\n")
                if line.startswith(b">"):
                    if name is not None:
                        self._seqs[name] = b"".join(chunks)
                    name = line[1:].split()[0].decode()
                    self._order.append(name)
                    chunks = []
                else:
                    chunks.append(line)
        if name is not None:
            self._seqs[name] = b"".join(chunks)

    def fetch(self, contig: str) -> bytes:
        return self._seqs[contig]

    def __contains__(self, contig: str) -> bool:
        return contig in self._seqs

    def references(self) -> List[str]:
        return list(self._order)

    def lengths(self) -> List[Tuple[str, int]]:
        return [(n, len(self._seqs[n])) for n in self._order]

    def write_fai(self, fai_path: str) -> None:
        """Write a standard 5-column .fai (name, length, offset,
        linebases, linewidth) reconstructed from the file layout."""
        entries = []
        with open(self.path, "rb") as fh:
            data = fh.read()
        off = 0
        while off < len(data):
            nl = data.find(b"\n", off)
            if nl < 0:
                break
            line = data[off:nl]
            if line.startswith(b">"):
                name = line[1:].split()[0].decode()
                seq_off = nl + 1
                # Measure first sequence line.
                nl2 = data.find(b"\n", seq_off)
                linewidth = (nl2 - seq_off + 1) if nl2 >= 0 else 0
                first = data[seq_off:nl2 if nl2 >= 0 else len(data)]
                linebases = len(first.rstrip(b"\r"))
                entries.append((name, len(self._seqs.get(name, b"")),
                                seq_off, linebases, linewidth))
            off = nl + 1
        with open(fai_path, "w") as out:
            for name, ln, seq_off, lb, lw in entries:
                out.write(f"{name}\t{ln}\t{seq_off}\t{lb}\t{lw}\n")


def write_fasta(path: str, seqs: Dict[str, bytes], width: int = 80) -> None:
    with open(path, "wb") as out:
        for name, seq in seqs.items():
            out.write(b">" + name.encode() + b"\n")
            for off in range(0, len(seq), width):
                out.write(seq[off:off + width] + b"\n")
