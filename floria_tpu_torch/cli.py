"""Command line of the PyTorch port: the reference's flags, with parity
to the reference binary (bin/floria.rs:26-200, parse_cmd_line.rs:11-196),
plus `--device`.

    python -m floria_tpu_torch.cli -b BAM -v VCF -r FASTA -o OUT \
        [--device cuda|cpu] [--num-devices N] \
        [--num-processes N --process-id K --coordinator HOST:PORT]

`--device` defaults to cuda and raises when no CUDA device is present.
Block batches shard over the local cards (`--num-devices`, default all;
on the CPU, N shards of the one device); `--num-processes` shards the
contigs over processes, rank 0 hosting the barrier's store at
`--coordinator`.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from . import constants
from .options import Options
from .parallel.mesh import make_block_mesh
from .parallel.multihost import run_multihost
from .pipeline import run


def _reference_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="floria-tpu",
        description=("floria-tpu - TPU-native strain phasing for short or "
                     "long-read shotgun metagenomic sequencing.\n\n"
                     "Example usage:\n"
                     "floria-tpu -b bamfile.bam -v vcffile.vcf "
                     "-r reference.fa -o results\n"),
        formatter_class=argparse.RawDescriptionHelpFormatter)
    req = p.add_argument_group("REQUIRED")
    req.add_argument("-b", dest="bam", required=True, metavar="BAM FILE",
                     help="Sorted bam file to phase (no index needed).")
    req.add_argument("-v", dest="vcf", required=True, metavar="VCF FILE",
                     help="VCF file with contig header information.")
    req.add_argument("-r", dest="reference_fasta", required=True,
                     metavar="FASTA FILE",
                     help="Reference fasta for the BAM file.")
    p.add_argument("-t", "--threads", type=int, default=10,
                   help="Number of host worker threads. (default: 10)")
    inp = p.add_argument_group("INPUT")
    inp.add_argument("--snp-count-filter", type=int, default=100,
                     help="Skip contigs with fewer SNPs. (default: 100)")
    inp.add_argument("--ignore-monomorphic", action="store_true",
                     help="Ignore SNPs with minor allele frequency < -e.")
    inp.add_argument("-X", "--no-supp", action="store_true",
                     dest="no_supp",
                     help="Do not use supplementary alignments.")
    inp.add_argument("-H", "--hybrid", metavar="BAM FILE", default="",
                     help=argparse.SUPPRESS)
    inp.add_argument("-G", "--contigs", nargs="+", default=[],
                     dest="list_to_phase", metavar="CONTIG",
                     help="Phase only these contigs.")
    out = p.add_argument_group("OUTPUT")
    out.add_argument("-o", "--output-dir", default="floria_out_dir",
                     help="Output folder. (default: floria_out_dir)")
    out.add_argument("--overwrite", action="store_true",
                     help="Force overwrite for output directory.")
    out.add_argument("--output-reads", action="store_true",
                     help="Output reads for the resulting haplosets.")
    out.add_argument("--gzip-reads", action="store_true",
                     help="Gzip output reads.")
    out.add_argument("--extra-trimming", action="store_true",
                     dest="trim_reads",
                     help="Trim reads extra carefully against the "
                          "reference.")
    out.add_argument("--reassign-short", action="store_true",
                     help=argparse.SUPPRESS)
    alg = p.add_argument_group("ALGORITHM")
    alg.add_argument("-e", "--epsilon", type=float, default=None,
                     help="Estimated allele call error rate. (default: "
                          "estimated from data)")
    alg.add_argument("-n", "--beam-solns", type=int, default=10,
                     dest="max_number_solns",
                     help="Maximum number of beam-search solutions. "
                          "(default: 10)")
    alg.add_argument("-p", "--max-ploidy", type=int, default=5,
                     help="Maximum strain count to phase up to. "
                          "(default: 5)")
    alg.add_argument("-l", "--block-length", type=int, default=None,
                     help="Block length in bp for the flow graph. "
                          "(default: 66th pct read length, min 500)")
    alg.add_argument("-d", "--snp-density", type=float, default=0.0005,
                     help="Minimum SNP density for a block to be phased. "
                          "(default: 0.0005)")
    alg.add_argument("--no-stop-heuristic", action="store_true",
                     help="Disable the MEC stopping heuristic.")
    alg.add_argument("-s", "--ploidy-sensitivity", type=int, default=2,
                     choices=(1, 2, 3),
                     help="Stopping heuristic sensitivity. (default: 2)")
    alg.add_argument("-m", "--mapq-cutoff", type=int, default=15,
                     help="Primary MAPQ cutoff. (default: 15)")
    alg.add_argument("--supp-aln-dist-cutoff", type=int, default=40000,
                     help="Max distance between supp. alignments. "
                          "(default: 40000)")
    alg.add_argument("--bin-by-cov", action="store_true",
                     dest="do_binning", help=argparse.SUPPRESS)
    alg.add_argument("-q", dest="use_qual_scores", action="store_true",
                     help=argparse.SUPPRESS)
    p.add_argument("--debug", action="store_true",
                   help="Debugging output.")
    p.add_argument("--trace", action="store_true", help="Trace output.")
    tpu = p.add_argument_group("TPU")
    tpu.add_argument("--contig-batch", type=int, default=16,
                     help="Contigs per shared device-batch group.")
    tpu.add_argument("--num-devices", type=int, default=None,
                     help="Devices to shard block batches over "
                          "(default: all local devices).")
    tpu.add_argument("--sweep-cap", default="auto", metavar="{auto,N}",
                     help="Read-site cells per phasing dispatch: 'auto' "
                          "probes the device link once (small batches "
                          "on a local chip, large on a high-latency "
                          "link); or an integer. Output-invariant. "
                          "(default: auto)")
    tpu.add_argument("--resume", action="store_true",
                     help="Skip contigs whose outputs already exist "
                          "(per-contig checkpointing).")
    tpu.add_argument("--keep-going", action="store_true",
                     help="Continue past per-contig failures.")
    tpu.add_argument("--num-processes", type=int, default=1,
                     help="Multi-host: total process count.")
    tpu.add_argument("--process-id", type=int, default=0,
                     help="Multi-host: this process's index.")
    tpu.add_argument("--coordinator", default=None,
                     help="Multi-host: coordinator address "
                          "host:port.")
    return p


def options_from_args(args: argparse.Namespace) -> Options:
    level = (logging.DEBUG if args.debug or args.trace else logging.INFO)
    logging.basicConfig(level=level,
                        format="%(asctime)s %(levelname)s %(message)s")

    epsilon = args.epsilon
    block_length = args.block_length
    if epsilon is None or block_length is None:
        from .ingest.autodetect import l_epsilon_auto_detect
        est_l, est_e = l_epsilon_auto_detect(args.bam)
        if epsilon is None:
            epsilon = est_e
            logging.info("Estimated -e is %s", est_e)
        if block_length is None:
            block_length = est_l
            logging.info("Estimated -l is %s", est_l)

    out_dir = args.output_dir
    if (os.path.exists(out_dir) and not args.overwrite
            and not args.resume):
        logging.error(
            "Output directory exists; use --overwrite to overwrite.")
        sys.exit(1)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "cmd.log"), "w") as f:
        f.write(" ".join(sys.argv) + " ")
    ploidy_tsv = os.path.join(out_dir, "contig_ploidy_info.tsv")
    if not (args.resume and os.path.exists(ploidy_tsv)):
        with open(ploidy_tsv, "w") as f:
            f.write(constants.CONTIG_PLOIDY_HEADER)

    return Options(
        bam_file=args.bam, vcf_file=args.vcf,
        reference_fasta=args.reference_fasta,
        short_bam_file=args.hybrid, hybrid=bool(args.hybrid),
        mapq_cutoff=args.mapq_cutoff, dont_use_supp_aln=args.no_supp,
        snp_count_filter=args.snp_count_filter,
        supp_aln_dist_cutoff=args.supp_aln_dist_cutoff,
        use_qual_scores=args.use_qual_scores, epsilon=epsilon,
        max_number_solns=args.max_number_solns,
        snp_density=args.snp_density, max_ploidy=args.max_ploidy,
        block_length=block_length,
        stopping_heuristic=not args.no_stop_heuristic,
        ignore_monomorphic=args.ignore_monomorphic,
        ploidy_sensitivity=args.ploidy_sensitivity,
        reassign_short=args.reassign_short, do_binning=args.do_binning,
        trim_reads=args.trim_reads, gzip=args.gzip_reads,
        output_reads=args.output_reads, out_dir=out_dir,
        overwrite=args.overwrite, num_threads=args.threads,
        list_to_phase=list(args.list_to_phase),
        contig_batch=args.contig_batch, num_devices=args.num_devices,
        sweep_cap=args.sweep_cap,
        resume=args.resume, keep_going=args.keep_going)


def build_parser():
    p = _reference_parser()
    p.prog = "floria-tpu-torch"
    p.add_argument("--device", default="cuda",
                   help="Torch device for the phasing kernels: cuda "
                        "(default; raises without a GPU) or cpu (the "
                        "plain PyTorch path).")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    mesh = make_block_mesh(args.num_devices, device=args.device)
    if args.num_processes > 1 and not args.coordinator:
        raise ValueError("--num-processes > 1 needs --coordinator "
                         "host:port (rank 0 hosts the store there)")
    options = options_from_args(args)
    if args.num_processes > 1:
        run_multihost(options, args.num_processes, args.process_id,
                      args.coordinator, device=mesh)
    else:
        run(options, device=mesh)


if __name__ == "__main__":
    main()
