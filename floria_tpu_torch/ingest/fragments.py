"""Record-level fragment extraction with the port's realigner.

Only `collect_contig_records` differs from floria_tpu/ingest/fragments.py
(its realigner import pulls in jax); the rest of the ingest is imported
from there unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from floria_tpu.frag import Frag
from floria_tpu.ingest.fragments import (alignment_passed_check,
                                         finalize_frags, frag_from_record)
from floria_tpu.ingest.vcf import ContigVcf
from floria_tpu.options import Options

from ..kernels.realign import SnpRealigner

__all__ = ["collect_contig_records", "finalize_frags"]


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
            from floria_tpu.ingest.fastingest import extract_contig_frags
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
