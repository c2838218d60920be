"""Scripts of the port, each the twin of the same-named script under
`scripts/` and run as

    python -m floria_tpu_torch.scripts.<name> ...

Host tools over a run's outputs, which touch no device and write the
JAX scripts' bytes: haplotag a BAM from one haploset file
(`haplotag_bam`) or from a whole result directory
(`haplotag_output_dir`), split a BAM per haploset (`get_bam_partition`)
and write strain contigs from vartigs (`output_snpped_contigs`).

Measurement scripts, on the card unless asked for `--device cpu`:
config #5 phased by 1, 2 and 4 processes (`multihost_bench`), K1's
roofline accounting (`mfu`), blocks/s over shards of the block mesh
(`scaling_bench`) and the beam dispatch's cost per scan step
(`profile_beam`); and on one CPU core, with no card, the oracle
pipeline's e2e denominator (`oracle_e2e_baseline`)."""
