"""vartig-dump: BAM + VCF -> one vartig per contig.

Equivalent of the reference's second binary (bin/vartig-dump.rs:7-56):
groups ALL passing alignments of each contig into a single haplotype and
writes its consensus allele string — e.g. to turn a whole-genome alignment
of a strain against a reference into a vartig. It realigns nothing, so it
runs on the host alone:

    python -m floria_tpu_torch.vartig_dump -b BAM -v VCF [-o OUT]
"""

from __future__ import annotations

import argparse
import numpy as np

from .frag import sort_and_renumber
from .ingest import bam as bamlib
from .ingest.fragments import get_frags_from_bam
from .ingest.vcf import read_vcf
from .options import Options
from .out.writers import unweighted_counts


def write_alignment_as_vartig(frags, in_file: str, contig: str,
                              snp_to_genome_pos: np.ndarray,
                              left_snp: int, right_snp: int, out: str,
                              append: bool = False) -> None:
    """file_writer.rs:1031-1077: consensus over ALL fragments as one
    haplotype; '?' (code 15) where uncovered."""
    ids = [f.counter_id for f in frags]
    counts, has = unweighted_counts(frags, ids, left_snp, right_snp)
    alleles = []
    for s in range(right_snp - left_snp + 1):
        if not has[s]:
            alleles.append(15)
        else:
            alleles.append(int(counts[s].argmax()))
    rightmost = int(snp_to_genome_pos[right_snp - 1])
    leftmost = int(snp_to_genome_pos[left_snp - 1])
    mode = "a" if append else "w"
    with open(out, mode) as f:
        f.write(f">HAP{in_file}\tCONTIG:{contig}\t"
                f"SNPRANGE:{left_snp}-{right_snp}\t"
                f"BASERANGE:{leftmost}-{rightmost}\n")
        f.write("".join(chr(a + 48) for a in alleles) + "\n")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="vartig-dump-torch",
        description="Turn VCF + BAM -> Vartig. All alignments are grouped "
                    "together to form one vartig per contig.")
    p.add_argument("-b", dest="bam", required=True, metavar="BAMFILE")
    p.add_argument("-v", dest="vcf", required=True, metavar="VCFFILE")
    p.add_argument("-o", dest="output", default=None, metavar="OUTPUT",
                   help="Output file (default: BAMFILE_vartigs.txt)")
    args = p.parse_args(argv)

    # Reference overrides: MAPQ 30, effectively-unbounded supp distance
    # (vartig-dump.rs:31-35).
    options = Options(bam_file=args.bam, vcf_file=args.vcf,
                      mapq_cutoff=30, supp_aln_dist_cutoff=10**10)
    out = args.output or f"{args.bam}_vartigs.txt"
    contigs = bamlib.get_contigs_to_phase(args.bam)
    main_bam = bamlib.BamFile(args.bam)
    vcf_profile = read_vcf(args.vcf, contigs)

    first = True
    for contig in contigs:
        if contig not in vcf_profile:
            continue
        cv = vcf_profile.get(contig)
        # No reference sequence: nothing is realigned, no device is used.
        frags, _ = get_frags_from_bam(main_bam, None, cv, options, None,
                                      contig, device=None)
        if not frags:
            continue
        frags = sort_and_renumber(frags)
        for f in frags:
            f.freeze()
        write_alignment_as_vartig(frags, out, contig, cv.genome_pos, 1,
                                  cv.num_snps, out, append=not first)
        first = False


if __name__ == "__main__":
    main()
