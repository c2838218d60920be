"""Generate strain contigs from vartigs by swapping called SNP alleles
into the reference sequence (equivalent of reference
scripts/output_snpped_contigs.py, without pysam/pyfaidx). Uncovered sites
('?') become N."""

import argparse

from ..ingest.fasta import FastaFile
from ..ingest.vcf import read_vcf


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-f", "--fasta", required=True)
    p.add_argument("-o", "--output-name", required=True)
    p.add_argument("-v", "--vcf", required=True)
    p.add_argument("-t", "--vartigs", required=True)
    args = p.parse_args(argv)

    fasta = FastaFile(args.fasta)
    prof = read_vcf(args.vcf)

    with open(args.vartigs) as f:
        lines = [line.strip() for line in f]

    with open(args.output_name, "w") as out:
        # Header and allele lines in pairs; a trailing odd line is
        # dropped.
        for i in range(0, len(lines) - 1, 2):
            fields = lines[i].split("\t")
            hapid = fields[0]
            contig = fields[1].split(":", 1)[1]
            snprange = list(map(int, fields[2].split(":")[1].split("-")))
            baserange = list(map(int, fields[3].split(":")[1].split("-")))
            seq = bytearray(fasta.fetch(contig)[baserange[0] - 1:
                                                baserange[1]])
            cv = prof.get(contig)
            vartig = lines[i + 1]
            for j, snp in enumerate(range(snprange[0], snprange[1] + 1)):
                gn = cv.snp_to_gn(snp)  # 0-based
                rel = gn - (baserange[0] - 1)
                if rel < 0 or rel >= len(seq) or j >= len(vartig):
                    continue
                ch = vartig[j]
                if ch == "?":
                    seq[rel] = ord("N")
                else:
                    alleles = cv.pos_allele_map[gn]
                    idx = int(ch)
                    if idx < len(alleles):
                        seq[rel] = alleles[idx]
            out.write(hapid + "\n")
            out.write(seq.decode() + "\n")
    print("Completed and written to output file")


if __name__ == "__main__":
    main()
