"""The oracle's inputs: one contig's fragments read as the pipeline reads
them (`pipeline._run_group`'s ingest), so the oracle phases the exact
fragments the pipeline phases. The port's copy of the JAX package's
`_ingest_like_pipeline` (tests/test_pipeline_oracle.py), plus the
hybrid path that test builds by hand.
"""

from __future__ import annotations

from ..frag import sort_and_renumber
from ..fragops import hybrid_correction
from ..ingest import bam as bamlib
from ..ingest.fasta import FastaFile
from ..ingest.fragments import collect_contig_records, finalize_frags
from ..ingest.vcf import read_vcf
from ..pipeline import open_bam


def ingest_like_pipeline(opts, contig: str, *, device):
    """(frags, frags without SNPs, ContigVcf) of `contig`: records,
    realignment against `opts.reference_fasta` (its NW partitions above
    the C++ threshold on `device`), pair and supplementary merging, then
    sort, renumber and freeze, as the pipeline does."""
    contigs = bamlib.get_contigs_to_phase(opts.bam_file)
    main_bam = open_bam(opts.bam_file)
    short_bam = (open_bam(opts.short_bam_file)
                 if opts.short_bam_file else None)
    cv = read_vcf(opts.vcf_file, contigs).get(contig)
    ref_seq = FastaFile(opts.reference_fasta).fetch(contig)
    id_map = collect_contig_records(main_bam, short_bam, cv, opts, ref_seq,
                                    contig, device=device)
    all_frags, frags_without_snps = finalize_frags(id_map, cv, opts)
    all_frags = sort_and_renumber(all_frags)
    for f in all_frags:
        f.freeze()
    for f in frags_without_snps:
        f.freeze()
    return all_frags, frags_without_snps, cv


def oracle_inputs(opts, contig: str, *, device):
    """(frags, short_frags, combined, ContigVcf): what phase_contig and
    the texts take. Without `opts.hybrid`, frags = combined and no short
    fragments. With it, as the pipeline: hybrid_correction polishes the
    long reads (then sorted and renumbered) and sets the short ones
    apart, whose counter ids continue after the long ones in
    `combined`."""
    all_frags, _nosnp, cv = ingest_like_pipeline(opts, contig,
                                                 device=device)
    if not opts.hybrid:
        return all_frags, [], all_frags, cv
    final_frags, short_frags = hybrid_correction(all_frags)
    final_frags = sort_and_renumber(final_frags)
    combined = list(final_frags)
    for f in short_frags:
        f.counter_id = len(combined)
        combined.append(f)
    return final_frags, short_frags, combined, cv


def contig_length(fasta_path: str, contig: str) -> int:
    """The contig's length in the reference FASTA (the ploidy row's
    denominator, as the pipeline takes it from the fetched sequence)."""
    return len(FastaFile(fasta_path).fetch(contig))
