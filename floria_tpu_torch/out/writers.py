"""Output emission: vartigs, haplosets, vartig_info, summary TSVs, FASTQ.

Byte-format parity with file_writer.rs (write_haplotypes:699-917,
write_fragset_haplotypes:308-369, write_all_parts_file:919-993,
write_nosnp_reads_parts:151-166, write_reads:371-576). Consensus alleles
for vartigs use unweighted counts; ties resolve to the smallest allele
index (the reference's hashmap-order pick is unspecified).
"""

from __future__ import annotations

import gzip
import os
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np

from .. import constants
from ..frag import Frag
from ..options import Options
from ..post.hapq import errors_cov_from_frags, fids_array, get_hapq

_COMP = bytes.maketrans(b"ACGTacgtNn", b"TGCAtgcaNn")


def revcomp(seq: bytes) -> bytes:
    return seq.translate(_COMP)[::-1]


def unweighted_counts(frags: Sequence[Frag], frag_ids, left: int,
                      right: int, csr=None) -> Tuple[np.ndarray,
                                                     np.ndarray]:
    """(counts[S, A], covered[S]) over [left, right], one unit per read."""
    if csr is not None:
        counts = csr.window_counts(fids_array(frag_ids), left, right,
                                   weighted=False)
        return counts, counts.sum(axis=-1) > 0
    S = right - left + 1
    counts = np.zeros((S, constants.MAX_ALLELES))
    for fid in frag_ids:
        f = frags[int(fid)]
        sel = (f.snps >= left) & (f.snps <= right)
        np.add.at(counts, (f.snps[sel] - left, f.alleles[sel]), 1.0)
    return counts, counts.sum(axis=-1) > 0


def write_outputs(parts: List[Set[int]], ranges: List[Tuple[int, int]],
                  out_dir: str, contig: str, frags: Sequence[Frag],
                  snp_to_genome_pos: np.ndarray, options: Options,
                  snpless_frags: Sequence[Frag],
                  contig_len: int, csr=None) -> None:
    """Per-contig output hub (file_writer.rs:21-84). `out_dir` is the
    contig's output directory."""
    os.makedirs(out_dir, exist_ok=True)
    hapqs, rel_err, avg_err = get_hapq(parts, ranges, frags,
                                       snp_to_genome_pos,
                                       options.block_length, csr=csr)
    write_haplotypes(parts, ranges, out_dir, contig, frags,
                     snp_to_genome_pos, hapqs, rel_err, options.out_dir,
                     avg_err, contig_len, ploidy_tsv=options.ploidy_tsv,
                     csr=csr)
    write_all_parts_file(parts, ranges, out_dir, contig, contig, frags,
                         snp_to_genome_pos, hapqs, rel_err, csr=csr)
    write_nosnp_reads_parts(out_dir, snpless_frags)
    if options.output_reads:
        write_reads(parts, ranges, out_dir, frags,
                    extend_read_clipping=not options.trim_reads,
                    hapqs=hapqs, gzip_out=options.gzip)
        write_nosnp_reads(out_dir, snpless_frags, options.gzip)


def _fmt_header(i: int, out_dir: str, contig: str, left: int, right: int,
                left_gn: int, right_gn: int, cov: float, err: float,
                hapq: int, rel: float) -> str:
    return (f">HAP{i}.{out_dir}\tCONTIG:{contig}\t"
            f"SNPRANGE:{left}-{right}\tBASERANGE:{left_gn}-{right_gn}\t"
            f"COV:{cov:.3f}\tERR:{err:.4f}\tHAPQ:{hapq}\t"
            f"REL_ERR:{rel:.3f}\n")


def write_haplotypes(parts, ranges, out_dir: str, contig: str, frags,
                     snp_to_genome_pos, hapqs, rel_err, top_dir: str,
                     avg_err: float, contig_len: int,
                     ploidy_tsv: str = "contig_ploidy_info.tsv",
                     csr=None) -> None:
    num_snps = len(snp_to_genome_pos)
    covered = np.zeros(num_snps)
    coverage = np.zeros(num_snps)
    covered_q = {15: np.zeros(num_snps), 30: np.zeros(num_snps),
                 45: np.zeros(num_snps)}
    total_bases_covered = 0

    vartig_path = os.path.join(out_dir, f"{contig}.vartigs")
    info_path = os.path.join(out_dir, "vartig_info.txt")
    with open(vartig_path, "w") as vf, open(info_path, "w") as inf:
        for i, ids in enumerate(parts):
            if not ids:
                continue
            left, right = ranges[i]
            if left > right:
                raise AssertionError((left, right, contig))
            left_gn = int(snp_to_genome_pos[left - 1])
            right_gn = int(snp_to_genome_pos[right - 1])
            total_bases_covered += right_gn - left_gn
            cov, err, _te, _tc = errors_cov_from_frags(frags, ids, left,
                                                       right, csr=csr)
            hap_q = hapqs[i]
            covered[left - 1:right] += 1.0
            coverage[left - 1:right] += cov
            for q, arr in covered_q.items():
                if hap_q >= q:
                    arr[left - 1:right] += 1.0
            vf.write(_fmt_header(i, out_dir, contig, left, right,
                                 left_gn + 1, right_gn + 1, cov, err,
                                 hap_q, rel_err[i]))
            alleles = _write_fragset_haplotypes(
                inf, frags, ids, f"{i}", out_dir, snp_to_genome_pos, left,
                right, csr=csr)
            vf.write((np.asarray(alleles, np.uint8) + 48).tobytes()
                     .decode("latin-1") + "\n")

    nonzero = (covered > 0).sum()
    avg_ploidy = covered.sum() / num_snps if num_snps else float("nan")
    avg_q = {q: (arr.sum() / num_snps if num_snps else float("nan"))
             for q, arr in covered_q.items()}
    rough_cvg = coverage.sum() / nonzero if nonzero else float("nan")
    with open(os.path.join(top_dir, ploidy_tsv), "a") as pf:
        pf.write(f"{contig}\t{avg_ploidy:.3f}\t"
                 f"{total_bases_covered / contig_len:.3f}\t"
                 f"{rough_cvg:.3f}\t{total_bases_covered}\t"
                 f"{avg_q[15]:.3f}\t{avg_q[30]:.3f}\t{avg_q[45]:.3f}\t"
                 f"{avg_err:.4f}\n")


def _write_fragset_haplotypes(inf, frags, ids, name: str, out_dir: str,
                              snp_to_genome_pos, left: int,
                              right: int, csr=None) -> List[int]:
    """vartig_info.txt entry (file_writer.rs:308-369); returns the allele
    codes for the vartig string (15 -> '?')."""
    inf.write(f">HAP{name}.{out_dir}\tSNPRANGE:{left}-{right}\n")
    counts, has = unweighted_counts(frags, ids, left, right, csr=csr)
    if not has.any():
        return []
    # One buffered write; identical bytes to the per-field writes.
    bests = counts.argmax(axis=1)
    cnt_int = np.round(counts).astype(np.int64)
    have_gpos = len(snp_to_genome_pos) > 0
    A = constants.MAX_ALLELES
    S = right - left + 1
    if have_gpos:
        gpos = np.asarray(snp_to_genome_pos[left - 1:right], np.int64)
    else:
        gpos = np.full(S, -1, np.int64)  # < 0 renders as NA
    from .. import native
    buf = native.format_vartig_info(left, gpos, has, bests, cnt_int,
                                    counts > 0)
    if buf is not None:
        inf.write(buf.decode("ascii"))
    else:
        out: List[str] = []
        for s in range(S):
            pos = left + s
            if have_gpos:
                head = f"{pos}:{int(snp_to_genome_pos[pos - 1])}\t"
            else:
                head = f"{pos}:NA\t"
            if not has[s]:
                out.append(head + "?\tNA\t\n")
            else:
                row = counts[s]
                entries = "|".join(f"{a}:{cnt_int[s, a]}"
                                   for a in range(A) if row[a] > 0)
                out.append(f"{head}{bests[s]}\t{entries}\t\n")
        inf.write("".join(out))
    return np.where(has, bests, 15).tolist()


def write_all_parts_file(parts, ranges, out_dir: str, contig: str,
                         prefix: str, frags, snp_to_genome_pos, hapqs,
                         rel_err, csr=None) -> None:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{prefix}.haplosets")
    total_cov_all = 0.0
    total_err_all = 0.0
    with open(path, "w") as f:
        for i, ids in enumerate(parts):
            if not ids:
                continue
            ordered = sorted(ids, key=lambda fid: frags[fid].sort_key())
            if not ranges:
                f.write(f"#{i}\n")
            else:
                left, right = ranges[i]
                cov, err, te, tc = errors_cov_from_frags(frags, ids, left,
                                                         right, csr=csr)
                f.write(_fmt_header(
                    i, out_dir, contig, left, right,
                    int(snp_to_genome_pos[left - 1]) + 1,
                    int(snp_to_genome_pos[right - 1]) + 1, cov, err,
                    hapqs[i], rel_err[i]))
                total_cov_all += tc
                total_err_all += te
            for fid in ordered:
                fr = frags[fid]
                f.write(f"{fr.id}\t{fr.first_position}\t"
                        f"{fr.last_position}\n")
    if ranges and total_cov_all:
        import logging
        logging.getLogger("floria_tpu").info(
            "Final SNP error rate for all haplogroups is %s",
            total_err_all / total_cov_all)


def write_nosnp_reads_parts(out_dir: str, snpless_frags) -> None:
    with open(os.path.join(out_dir, "reads_without_snps.tsv"), "w") as f:
        f.write("READ_NAME\tREAD_LENGTH_IN_BASES\n")
        for frag in snpless_frags:
            length = sum(len(s) for s in frag.seq_string)
            f.write(f"{frag.id}\t{length}\n")


class _FastqSink:
    def __init__(self, path: str, gzip_out: bool):
        self.path = path
        self.fh = (gzip.open(path, "wb") if gzip_out
                   else open(path, "wb"))
        self.wrote = False

    def write(self, name: str, seq: bytes, qual: bytes) -> None:
        self.wrote = True
        self.fh.write(b"@" + name.encode() + b"\n" + seq + b"\n+\n"
                      + qual + b"\n")

    def close_or_remove(self) -> None:
        self.fh.close()
        if not self.wrote:
            os.remove(self.path)


def _write_paired_no_trim(s1: _FastqSink, s2: _FastqSink,
                          frag: Frag) -> None:
    if len(frag.seq_string[0]) == 0:
        s1.write(f"{frag.id}/1", b"N", b"!")
    else:
        s1.write(f"{frag.id}/1", frag.seq_string[0], frag.qual_string[0])
    if len(frag.seq_string[1]) == 0:
        s2.write(f"{frag.id}/2", b"N", b"!")
    else:
        s2.write(f"{frag.id}/2", revcomp(frag.seq_string[1]),
                 frag.qual_string[1])


def write_reads(parts, ranges, out_dir: str, frags,
                extend_read_clipping: bool, hapqs, gzip_out: bool) -> None:
    os.makedirs(os.path.join(out_dir, "short_reads"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "long_reads"), exist_ok=True)
    gz = ".gz" if gzip_out else ""
    ext = constants.EXTENSION_BASES
    for i, ids in enumerate(parts):
        if not ids or not ranges or hapqs[i] < constants.HAPQ_CUTOFF:
            continue
        left_snp, right_snp = ranges[i]
        sink = _FastqSink(
            os.path.join(out_dir, "long_reads", f"{i}_part.fastq{gz}"),
            gzip_out)
        sink1 = _FastqSink(
            os.path.join(out_dir, "short_reads",
                         f"{i}_part_paired1.fastq{gz}"), gzip_out)
        sink2 = _FastqSink(
            os.path.join(out_dir, "short_reads",
                         f"{i}_part_paired2.fastq{gz}"), gzip_out)
        for fid in sorted(ids, key=lambda fid: frags[fid].sort_key()):
            frag = frags[fid]
            if not any(len(s) for s in frag.seq_string):
                continue
            if frag.first_position > right_snp:
                continue
            if frag.last_position < left_snp:
                continue
            span = _trim_span(frag, left_snp, right_snp,
                              extend_read_clipping, ext)
            if span is None:
                continue
            left_seq, right_seq, right_pair = span
            if frag.is_paired:
                _write_paired_no_trim(sink1, sink2, frag)
            else:
                if left_seq > right_seq:
                    continue
                sink.write(frag.id,
                           frag.seq_string[0][left_seq:right_seq + 1],
                           frag.qual_string[0][left_seq:right_seq + 1])
        sink1.close_or_remove()
        sink2.close_or_remove()
        sink.close_or_remove()


def _trim_span(frag: Frag, left_snp: int, right_snp: int,
               extend: bool, ext: int) -> Optional[Tuple[int, int, int]]:
    """(left_seq_pos, right_seq_pos, right pair index) —
    file_writer.rs:468-538."""
    if frag.first_position > left_snp and extend:
        left_seq = 0
    else:
        tmp = left_snp
        while tmp not in frag.snp_pos_to_seq_pos:
            tmp += 1
            if tmp - left_snp > 10_000_000:
                raise AssertionError("left snp position not found")
        left_seq = frag.snp_pos_to_seq_pos[tmp][1]
    left_seq = left_seq - ext if left_seq > ext else 0

    if frag.last_position < right_snp and extend:
        right_pair = 1 if frag.is_paired else 0
        n = len(frag.seq_string[right_pair])
        right_seq = n - 1 if n else 0
    else:
        tmp = right_snp
        while tmp not in frag.snp_pos_to_seq_pos:
            if tmp == 0:
                break
            tmp -= 1
        if tmp == 0 and tmp not in frag.snp_pos_to_seq_pos:
            return None
        right_pair = frag.snp_pos_to_seq_pos[tmp][0]
        right_seq = frag.snp_pos_to_seq_pos[tmp][1]

    n = len(frag.seq_string[right_pair])
    if n == 0:
        right_seq = 0
    elif n > ext + 1 and right_seq < n - ext - 1:
        right_seq += ext
    else:
        right_seq = n - 1
    return left_seq, right_seq, right_pair


def write_nosnp_reads(out_dir: str, snpless_frags, gzip_out: bool) -> None:
    gz = ".gz" if gzip_out else ""
    sink = _FastqSink(
        os.path.join(out_dir, "long_reads", f"snpless.fastq{gz}"),
        gzip_out)
    sink1 = _FastqSink(
        os.path.join(out_dir, "short_reads", f"snpless_paired1.fastq{gz}"),
        gzip_out)
    sink2 = _FastqSink(
        os.path.join(out_dir, "short_reads", f"snpless_paired2.fastq{gz}"),
        gzip_out)
    for frag in snpless_frags:
        if frag.is_paired:
            _write_paired_no_trim(sink1, sink2, frag)
        else:
            if len(frag.seq_string[0]) == 0:
                sink.write(frag.id, b"N", b"!")
            else:
                sink.write(frag.id, frag.seq_string[0],
                           frag.qual_string[0])
    sink.close_or_remove()
    sink1.close_or_remove()
    sink2.close_or_remove()
