"""Generate a new BAM with HP:i haplotag tags for a single contig from a
haploset file (equivalent of reference scripts/haplotag_bam.py, without
pysam)."""

import argparse

from ..ingest.bam import BamFile
from ..out.haplotag import haplotag_records, read_haploset, write_bam_records


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-t", "--haploset", required=True)
    p.add_argument("-b", "--bam", required=True)
    p.add_argument("-o", "--output-name", required=True,
                   help="output name; '.bam' is appended")
    p.add_argument("-n", "--name-contig", required=True)
    p.add_argument("-q", "--min-hapq", type=int, default=0)
    args = p.parse_args(argv)

    parts = read_haploset(args.haploset, args.min_hapq)
    name_to_part = {}
    for i, names in parts.items():
        for n in names:
            name_to_part[n] = i
    bam = BamFile(args.bam)
    records = haplotag_records(bam, args.name_contig, name_to_part)
    out = args.output_name + ".bam"
    write_bam_records(out, bam, records)
    print(f"Done! HP:i tags are now added to {out}")


if __name__ == "__main__":
    main()
