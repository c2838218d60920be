"""Fragment extraction: BAM records -> SNP-space fragments.

Faithful reimplementation of the reference extraction semantics
(file_reader.rs:185-235 filters, :661-736 record walk, :491-659 pair and
supplementary merging), producing host Frag objects ready for tensor
packing. Record-level work is independent per record; the heavy inner loops
are vectorized with numpy (the reference parallelizes them with rayon,
file_reader.rs:388-437). `collect_contig_records` queues realignment on
the port's realigner and flushes it on the run's device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..frag import Frag
from ..kernels.realign import SnpRealigner
from ..options import Options
from . import bam as bamlib
from .bam import BamRecord
from .vcf import ContigVcf


def alignment_passed_check(flags: int, mapq: int, use_supplementary: bool,
                           filter_supplementary: bool,
                           mapq_cutoff: int) -> Tuple[bool, bool]:
    """(passed, is_supplementary) — file_reader.rs:185-235.

    Supplementary alignments of paired reads are always dropped; long-read
    supplementaries require MAPQ >= 60; primaries require MAPQ >= cutoff and
    no error/secondary flags.
    """
    is_paired = bool(flags & (bamlib.FLAG_FIRST_IN_PAIR |
                              bamlib.FLAG_SECOND_IN_PAIR))
    if flags & bamlib.FLAG_SUPPLEMENTARY:
        is_supp = True
        if is_paired:
            return False, True
        if not use_supplementary:
            return False, True
        if filter_supplementary and mapq < 60:
            return False, True
    else:
        is_supp = False
    if mapq < mapq_cutoff:
        return False, is_supp
    if flags & bamlib.ERRORS_MASK:
        return False, is_supp
    if flags & bamlib.FLAG_SECONDARY:
        return False, is_supp
    return True, is_supp


def frag_from_record(record: BamRecord, contig_vcf: ContigVcf,
                     counter_id: int) -> Frag:
    """Project one alignment onto SNP space (file_reader.rs:661-736).

    At each aligned (non-deleted) SNP site, the read base is matched against
    the VCF allele list; the first matching allele's index becomes the
    genotype. Sites where the read base matches no listed allele are
    dropped, as are deletions.
    """
    paired = bool(record.flag & (bamlib.FLAG_FIRST_IN_PAIR |
                                 bamlib.FLAG_SECOND_IN_PAIR))
    frag = Frag(record.qname, counter_id, paired)
    leading_hardclips = 0
    if record.flag & bamlib.FLAG_SUPPLEMENTARY:
        leading_hardclips = record.leading_hardclips()
    frag.first_pos_base = record.pos
    frag.last_pos_base = record.reference_end()

    qpos, rpos = bamlib.aligned_snp_pairs(record, contig_vcf.genome_pos)
    if len(qpos):
        read_bases = record.seq[qpos]
        read_quals = record.qual[qpos]
        snp_idx = np.searchsorted(contig_vcf.genome_pos, rpos)
        allele_mat = contig_vcf.allele_matrix()[snp_idx]  # [n, A] bases
        # First allele index whose base equals the read base; no-match -> -1.
        matches = allele_mat == read_bases[:, None]
        any_match = matches.any(axis=1)
        first_match = matches.argmax(axis=1)
        for i in np.flatnonzero(any_match):
            snp_pos = int(snp_idx[i]) + 1  # 1-based SNP counter
            frag.add_site(snp_pos, int(first_match[i]), int(read_quals[i]),
                          0, int(qpos[i]) + leading_hardclips)

    # Primary payloads: sequence and phred+33 qualities, 255-clamped
    # (file_reader.rs:728-734). For supplementary records the reference
    # still overwrites seq_string[0]; we match that.
    frag.seq_string[0] = record.seq.tobytes()
    q = record.qual.astype(np.uint16) + 33
    frag.qual_string[0] = np.minimum(q, 255).astype(np.uint8).tobytes()
    return frag


def combine_frags(id_to_frags: Dict[str, List[Tuple[int, Frag]]],
                  contig_vcf: ContigVcf, options: Options) -> List[Frag]:
    """Merge read pairs and long-read supplementary alignments
    (file_reader.rs:491-659).

    - Exactly two paired records: merge mate 2 into mate 1 (second mate's
      sites overwrite shared SNPs; payload stored at pair index 1).
    - One non-supplementary record: passthrough.
    - Otherwise a supplementary group: if any genomic gap between successive
      SNP intervals exceeds supp_aln_dist_cutoff, keep the primary only;
      groups without a primary are dropped; else merge all into the primary.
    """
    ref_frags: List[Frag] = []
    for _qname, frags in id_to_frags.items():
        if (len(frags) == 2 and frags[0][1].is_paired
                and frags[1][1].is_paired):
            frags = sorted(frags, key=lambda t: (t[0],
                                                 t[1].sort_key()))
            (flag_a, frag_a), (_flag_b, frag_b) = frags
            if flag_a & bamlib.FLAG_FIRST_IN_PAIR:
                first, second = frag_a, frag_b
            elif flag_a & bamlib.FLAG_SECOND_IN_PAIR:
                first, second = frag_b, frag_a
            else:
                continue  # not a proper pair; reference warns and skips
            _merge_into(first, second, pair_index=1)
            ref_frags.append(first)
        elif len(frags) == 1 and not (frags[0][0]
                                      & bamlib.FLAG_SUPPLEMENTARY):
            ref_frags.append(frags[0][1])
        else:
            supp_intervals = sorted(
                (f.first_position, f.last_position)
                for _fl, f in frags if f.num_sites)
            take_primary_only = False
            for i in range(len(supp_intervals) - 1):
                gap = (contig_vcf.snp_to_gn(supp_intervals[i + 1][0])
                       - contig_vcf.snp_to_gn(supp_intervals[i][1]))
                if gap > options.supp_aln_dist_cutoff:
                    take_primary_only = True
                    break
            primary_index = None
            for i, (fl, _f) in enumerate(frags):
                if not (fl & bamlib.FLAG_SUPPLEMENTARY):
                    primary_index = i
            if primary_index is None:
                continue  # only supplementary alignments survived filtering
            primary = frags[primary_index][1]
            if not take_primary_only:
                for i, (_fl, f) in enumerate(frags):
                    if i != primary_index:
                        _merge_into(primary, f, pair_index=None)
            ref_frags.append(primary)
    return ref_frags


def _merge_into(dst: Frag, src: Frag, pair_index: Optional[int]) -> None:
    """Extend dst with src's SNP profile; src overwrites shared keys
    (hashmap extend semantics, file_reader.rs:539-562, 637-651)."""
    dst.seq_dict.update(src.seq_dict)
    dst.qual_dict.update(src.qual_dict)
    dst.first_position = min(dst.first_position, src.first_position)
    dst.last_position = max(dst.last_position, src.last_position)
    dst.first_pos_base = min(dst.first_pos_base, src.first_pos_base)
    # The reference takes the min for last_pos_base too in both merge paths
    # (file_reader.rs:549, 647); replicated for output parity.
    dst.last_pos_base = min(dst.last_pos_base, src.last_pos_base)
    if pair_index is not None:
        dst.seq_string[pair_index] = src.seq_string[0]
        dst.qual_string[pair_index] = src.qual_string[0]
        for snp_pos, (_pair, seq_pos) in src.snp_pos_to_seq_pos.items():
            dst.snp_pos_to_seq_pos[snp_pos] = (pair_index, seq_pos)
    else:
        dst.snp_pos_to_seq_pos.update(src.snp_pos_to_seq_pos)


def get_frags_from_bam(main_bam, short_bam, contig_vcf: ContigVcf,
                       options: Options, ref_seq: Optional[bytes],
                       contig: str, *, device
                       ) -> Tuple[List[Frag], List[Frag]]:
    """Extract, realign, and merge fragments for one contig
    (file_reader.rs:343-462). Returns (frags with SNPs, frags without).
    With a `ref_seq` the realignment flushes on `device`; without one no
    device is touched."""
    id_to_frags = collect_contig_records(main_bam, short_bam, contig_vcf,
                                         options, ref_seq, contig,
                                         device=device)
    return finalize_frags(id_to_frags, contig_vcf, options)


def collect_contig_records(main_bam, short_bam, contig_vcf: ContigVcf,
                           options: Options, ref_seq: Optional[bytes],
                           contig: str, realign_pool=None, *, device
                           ) -> Dict[str, List[Tuple[int, Frag]]]:
    """Record-level extraction + realignment queueing
    (file_reader.rs:343-462). With a shared realign_pool the flush is
    the caller's job and must happen before finalize_frags; without
    one, realignment flushes here, on `device`."""
    filter_supplementary = True
    use_supplementary = not options.dont_use_supp_aln

    id_to_frags: Dict[str, List[Tuple[int, Frag]]] = {}
    realigner = None
    if ref_seq is not None:
        realigner = SnpRealigner(ref_seq, contig_vcf, pool=realign_pool)

    for bam_obj in (short_bam, main_bam):
        if bam_obj is None:
            continue
        if hasattr(bam_obj, "rec_off"):  # native FastBam path
            from .fastingest import extract_contig_frags
            try:
                tid = bam_obj.references.index(contig)
            except ValueError:
                continue
            sub = extract_contig_frags(bam_obj, contig_vcf, options,
                                       tid, realigner=realigner)
            for qname, entries in sub.items():
                id_to_frags.setdefault(qname, []).extend(entries)
            continue
        for count, record in enumerate(bam_obj.fetch(contig)):
            if record.tid < 0:
                continue
            passed, _is_supp = alignment_passed_check(
                record.flag, record.mapq, use_supplementary,
                filter_supplementary, options.mapq_cutoff)
            if not passed:
                continue
            frag = frag_from_record(record, contig_vcf, count)
            if realigner is not None:
                realigner.realign(frag)
            id_to_frags.setdefault(record.qname, []).append(
                (record.flag, frag))
    if realigner is not None and realign_pool is None:
        realigner.flush(device)
    return id_to_frags


def finalize_frags(id_to_frags: Dict[str, List[Tuple[int, Frag]]],
                   contig_vcf: ContigVcf, options: Options
                   ) -> Tuple[List[Frag], List[Frag]]:
    """Pair/supplementary merging + SNP split; realignment writes must
    have landed first."""
    ref_frags = combine_frags(id_to_frags, contig_vcf, options)
    with_snps = [f for f in ref_frags if f.num_sites]
    without_snps = [f for f in ref_frags if not f.num_sites]
    return with_snps, without_snps
