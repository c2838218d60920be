"""Haplotag a BAM over ALL contigs in a result directory (equivalent of
reference scripts/haplotag_output_dir.py, without pysam)."""

import argparse
import glob
import os

from ..ingest.bam import BamFile
from ..out.haplotag import haplotag_records, read_haploset, write_bam_records


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-d", "--result-directory", required=True)
    p.add_argument("-b", "--bam", required=True)
    p.add_argument("-o", "--output-name", required=True)
    p.add_argument("-q", "--min-hapq", type=int, default=1)
    args = p.parse_args(argv)

    bam = BamFile(args.bam)
    all_records = []
    for dir_object in sorted(glob.glob(args.result_directory + "/*")):
        if not os.path.isdir(dir_object):
            continue
        contig = os.path.basename(dir_object)
        # Unsorted: the first match in the directory's listing order.
        haplosets = glob.glob(dir_object + "/*haploset*")
        if not haplosets:
            print(f"ERROR: no haploset file for contig {contig}. "
                  "Skipping ...")
            continue
        parts = read_haploset(haplosets[0], args.min_hapq)
        name_to_part = {}
        for i, names in parts.items():
            for n in names:
                name_to_part[n] = i
        print(f"Tagging for contig {contig} ...")
        all_records.extend(haplotag_records(bam, contig, name_to_part))
    out = args.output_name + ".bam"
    write_bam_records(out, bam, all_records)
    print(f"Done! HP:i tags are now added to {out}")


if __name__ == "__main__":
    main()
