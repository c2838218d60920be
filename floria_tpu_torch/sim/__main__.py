"""CLI for the community simulator: generate BAM+VCF+FASTA mock data.

The reference ships a 3-strain Klebsiella mock for its quick start
(README.md:66-75) whose binary blobs are not distributable here; this
generates an equivalent synthetic community:

    python -m floria_tpu_torch.sim -o mock3 --strains 3 --length 100000
    python -m floria_tpu_torch.cli -b mock3/sim.bam -v mock3/sim.vcf \
        -r mock3/sim.fa -o results
"""

import argparse

from .simulate import SimConfig, simulate


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="floria-tpu-torch-sim",
                                description=__doc__)
    p.add_argument("-o", "--out-dir", required=True)
    p.add_argument("--strains", type=int, default=3)
    p.add_argument("--length", type=int, default=100_000)
    p.add_argument("--snps", type=int, default=None,
                   help="SNP count (default: length/200)")
    p.add_argument("--coverage", type=float, default=12.0,
                   help="per-strain coverage")
    p.add_argument("--read-length", type=int, default=8000)
    p.add_argument("--error-rate", type=float, default=0.02)
    p.add_argument("--paired", action="store_true",
                   help="simulate paired-end short reads")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--contig-name", default="sim_contig")
    args = p.parse_args(argv)

    cfg = SimConfig(
        contig_name=args.contig_name, contig_len=args.length,
        num_strains=args.strains,
        num_snps=args.snps or max(50, args.length // 200),
        coverage_per_strain=args.coverage,
        read_length=args.read_length, error_rate=args.error_rate,
        paired=args.paired, seed=args.seed)
    truth = simulate(cfg, args.out_dir)
    print(f"Wrote {args.out_dir}/sim.bam, sim.vcf, sim.fa "
          f"({cfg.num_strains} strains, {cfg.num_snps} SNPs, "
          f"{len(truth.read_strains)} reads)")


if __name__ == "__main__":
    main()
