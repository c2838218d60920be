"""Partition a BAM file into per-haploset BAMs (equivalent of reference
scripts/get_bam_partition.py, without pysam)."""

import argparse

from ..ingest.bam import BamFile
from ..out.haplotag import (read_haploset, record_passthrough,
                            write_bam_records)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-t", "--haplosets", required=True, nargs="+")
    p.add_argument("-b", "--bam_file", required=True)
    p.add_argument("-p", "--prefix_name", default="split-bam")
    p.add_argument("-q", "--min-hapq", type=int, default=0)
    args = p.parse_args(argv)

    bam = BamFile(args.bam_file)
    for haploset in args.haplosets:
        print(f"Splitting bam file for {haploset} with {args.bam_file}")
        parts = read_haploset(haploset, args.min_hapq)
        # contig name = haploset filename without its last extension; a
        # name the BAM lacks takes every record of the BAM.
        contig = ".".join(haploset.split("/")[-1].split(".")[:-1])
        records = bam.fetch(contig) if contig in bam.references else list(
            bam.iter_records())
        buckets = {i: [] for i in parts}
        for rec in records:
            for i, names in parts.items():
                if rec.qname in names:
                    buckets[i].append(record_passthrough(rec))
                    break
        for i, recs in buckets.items():
            write_bam_records(f"{args.prefix_name}{i}.bam", bam, recs)
        print("Splitting complete")


if __name__ == "__main__":
    main()
