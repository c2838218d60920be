"""Host tools over a run's outputs, as modules of the port: haplotag a
BAM from one haploset file (`haplotag_bam`) or from a whole result
directory (`haplotag_output_dir`), split a BAM per haploset
(`get_bam_partition`) and write strain contigs from vartigs
(`output_snpped_contigs`). Each runs as

    python -m floria_tpu_torch.scripts.<name> ...

with the flags of the same-named script under `scripts/`, and writes its
bytes. None touches a device."""
