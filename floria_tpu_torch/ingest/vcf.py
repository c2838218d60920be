"""VCF ingest.

Replaces the reference's two htslib/bcf passes (file_reader.rs:116-181 and
239-314) with one text-level scan that builds both products:

- per-contig sorted genome positions of usable SNPs (snp_to_genome_pos),
- the VcfProfile maps: genome pos -> allele byte list, genome pos -> 1-based
  SNP counter, SNP counter -> genome pos.

A record is a usable SNP iff every allele (REF and each ALT) is a single
A/C/G/T character, case-insensitively (file_reader.rs:288-302); otherwise it
is skipped. Plain and bgzip/gzip-compressed VCF are supported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from . import bgzf

_ACGT = frozenset(b"ACGT")


def _warn_ghost_contigs(ghost) -> None:
    """VCF records for contigs the BAM header doesn't know are ignored;
    say so — a silently-empty output on a contig-name mismatch (e.g.
    'chr1' vs '1') is the classic dirty-data failure (the reference
    exits loudly on unreadable inputs, file_reader.rs:125,244; a
    name-mismatch there yields the same silent no-SNPs behavior this
    warning closes)."""
    if ghost:
        import logging

        logging.getLogger(__name__).warning(
            "VCF has records for %d contig(s) absent from the BAM "
            "header (ignored): %s", len(ghost),
            ", ".join(sorted(ghost)[:5])
            + ("..." if len(ghost) > 5 else ""))


@dataclasses.dataclass
class ContigVcf:
    """SNP table for one contig. SNP counters are 1-indexed."""
    # 0-based genome position per SNP, ascending (index i = SNP counter i+1).
    genome_pos: np.ndarray
    # genome position -> allele index list as bytes [ref, alt1, ...]
    pos_allele_map: Dict[int, bytes]
    # genome position -> 1-based SNP counter
    pos_to_snp: Dict[int, int]

    @property
    def num_snps(self) -> int:
        return len(self.genome_pos)

    def snp_to_gn(self, snp_counter: int) -> int:
        return int(self.genome_pos[snp_counter - 1])

    _allele_matrix_cache: np.ndarray = None

    def allele_matrix(self) -> np.ndarray:
        """[num_snps, MAX_ALLELES] uint8 allele bases, 0-padded. Cached."""
        if self._allele_matrix_cache is None:
            from .. import constants
            out = np.zeros((self.num_snps, constants.MAX_ALLELES),
                           dtype=np.uint8)
            for i, pos in enumerate(self.genome_pos):
                al = self.pos_allele_map[int(pos)]
                out[i, :len(al)] = np.frombuffer(al, dtype=np.uint8)
            self._allele_matrix_cache = out
        return self._allele_matrix_cache


class VcfProfile:
    """Per-contig SNP profiles (types_structs.rs:54-58)."""

    def __init__(self, contigs: Dict[str, ContigVcf]):
        self.contigs = contigs

    def __contains__(self, contig: str) -> bool:
        return contig in self.contigs

    def get(self, contig: str) -> ContigVcf:
        return self.contigs[contig]

    def snp_to_genome_pos_map(self) -> Dict[str, List[int]]:
        """Contig -> list of 0-based SNP genome positions
        (file_reader.rs:116-181 equivalent)."""
        return {name: [int(p) for p in cv.genome_pos]
                for name, cv in self.contigs.items()}


def _read_vcf_native(data: bytes, restrict) -> "VcfProfile":
    """Native single-pass SNP scan (same record filter as the Python
    loop below, which stays as the spec/fallback); None without the
    C++ runtime."""
    from .. import constants, native

    lib = native.get_lib()
    if lib is None or not hasattr(lib, "floria_parse_vcf"):
        return None
    import ctypes

    lib.floria_parse_vcf.restype = ctypes.c_int64
    lib.floria_parse_vcf.argtypes = [
        ctypes.c_char_p, ctypes.c_int64] + [ctypes.c_void_p] * 9
    i64 = ctypes.c_int64
    runs, abytes, nbytes = i64(0), i64(0), i64(0)
    n = lib.floria_parse_vcf(data, len(data), ctypes.byref(runs),
                             ctypes.byref(abytes), ctypes.byref(nbytes),
                             None, None, None, None, None, None)
    if n < 0:
        return None
    pos = np.empty(n, np.int64)
    allele_buf = np.empty(int(abytes.value), np.uint8)
    allele_end = np.empty(n, np.int64)
    run_id = np.empty(n, np.int32)
    name_buf = np.empty(int(nbytes.value), np.uint8)
    name_end = np.empty(int(runs.value), np.int64)

    def p(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    lib.floria_parse_vcf(data, len(data), ctypes.byref(runs),
                         ctypes.byref(abytes), ctypes.byref(nbytes),
                         p(pos), p(allele_buf), p(allele_end), p(run_id),
                         p(name_buf), p(name_end))
    names = []
    prev = 0
    raw = name_buf.tobytes()
    for e in name_end:
        names.append(raw[prev:int(e)].decode())
        prev = int(e)
    al_raw = allele_buf.tobytes()
    allele_start = np.concatenate(([0], allele_end[:-1]))

    by_contig: Dict[str, List[int]] = {}
    ghost = set()
    for r, name in enumerate(names):
        if restrict is not None and name not in restrict:
            ghost.add(name)
            continue
        by_contig.setdefault(name, []).append(r)
    _warn_ghost_contigs(ghost)
    contigs = {}
    for name, rids in by_contig.items():
        sel = np.isin(run_id, np.asarray(rids, np.int32))
        gp = pos[sel]
        st = allele_start[sel]
        en = allele_end[sel]
        als = [al_raw[int(a):int(b)] for a, b in zip(st, en)]
        cv = ContigVcf(
            genome_pos=gp,
            pos_allele_map=dict(zip((int(x) for x in gp), als)),
            pos_to_snp={int(x): i + 1 for i, x in enumerate(gp)})
        lens = en - st
        A = constants.MAX_ALLELES
        if len(gp) and lens.max() <= A:
            mat = np.zeros((len(gp), A), np.uint8)
            cols = np.arange(int(lens.max()))
            mask = cols[None, :] < lens[:, None]
            flat_idx = (st[:, None] + cols[None, :])[mask]
            mat[np.broadcast_to(
                np.arange(len(gp))[:, None], mask.shape)[mask],
                np.broadcast_to(cols[None, :], mask.shape)[mask]] = \
                allele_buf[flat_idx]
            if len(np.unique(gp)) != len(gp):
                # duplicate positions: the dict is last-wins; mirror it
                for i, x in enumerate(gp):
                    a = cv.pos_allele_map[int(x)]
                    row = np.zeros(A, np.uint8)
                    row[:len(a)] = np.frombuffer(a, np.uint8)
                    mat[i] = row
            cv._allele_matrix_cache = mat
        contigs[name] = cv
    return VcfProfile(contigs)


def read_vcf(path: str, ref_chroms: List[str] = None) -> VcfProfile:
    data = bgzf.read_file(path)
    restrict = set(ref_chroms) if ref_chroms is not None else None
    fast = _read_vcf_native(data, restrict)
    if fast is not None:
        return fast
    per_contig_pos: Dict[str, List[int]] = {}
    per_contig_alleles: Dict[str, Dict[int, bytes]] = {}
    ghost = set()
    warned = False
    for line in data.split(b"\n"):
        if not line or line.startswith(b"#"):
            continue
        fields = line.split(b"\t", 5)
        if len(fields) < 5:
            continue
        chrom = fields[0].decode()
        if restrict is not None and chrom not in restrict:
            ghost.add(chrom)
            continue
        # Collect REF + comma-separated ALT alleles in record order; the
        # allele index stored on fragments is the position in this list
        # (file_reader.rs:297, frag_from_record:702-710).
        alleles = [fields[3]] + fields[4].split(b",")
        is_snp = True
        al_bytes = bytearray()
        for al in alleles:
            if len(al) != 1 or al.upper()[0] not in _ACGT:
                is_snp = False
                if not warned and len(al) == 1:
                    warned = True
                break
            al_bytes.append(al[0])
        if not is_snp:
            continue
        pos = int(fields[1]) - 1  # VCF POS is 1-based
        per_contig_pos.setdefault(chrom, []).append(pos)
        per_contig_alleles.setdefault(chrom, {})[pos] = bytes(al_bytes)

    _warn_ghost_contigs(ghost)
    contigs = {}
    for chrom, positions in per_contig_pos.items():
        gp = np.asarray(positions, dtype=np.int64)
        pos_to_snp = {int(p): i + 1 for i, p in enumerate(gp)}
        contigs[chrom] = ContigVcf(genome_pos=gp,
                                   pos_allele_map=per_contig_alleles[chrom],
                                   pos_to_snp=pos_to_snp)
    return VcfProfile(contigs)
