"""Run configuration.

Field-for-field parity with the reference Options struct
(the reference's src/types_structs.rs:22-51) plus TPU-specific execution
settings that have no reference analog (device batching / mesh controls).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class Options:
    # --- Inputs (types_structs.rs:23-24, 40, 42) ---
    bam_file: str = ""
    vcf_file: str = ""
    reference_fasta: str = ""
    short_bam_file: str = ""

    # --- Filtering (types_structs.rs:28, 30, 43, 49-50) ---
    mapq_cutoff: int = 15
    dont_use_supp_aln: bool = False
    snp_count_filter: int = 100
    supp_aln_dist_cutoff: int = 40000

    # --- Algorithm (types_structs.rs:25, 29, 33-35, 39, 44-45, 48) ---
    use_qual_scores: bool = False
    epsilon: float = 0.04
    max_number_solns: int = 10
    snp_density: float = 0.0005
    max_ploidy: int = 5
    block_length: int = 15000
    stopping_heuristic: bool = True
    ignore_monomorphic: bool = False
    ploidy_sensitivity: int = 2

    # --- Modes (types_structs.rs:31-32, 37, 41) ---
    hybrid: bool = False
    reassign_short: bool = False
    do_binning: bool = False
    trim_reads: bool = False

    # --- Output (types_structs.rs:26-27, 36, 46-47) ---
    gzip: bool = False
    output_reads: bool = False
    out_dir: str = "floria_out_dir"
    overwrite: bool = False
    num_threads: int = 10
    list_to_phase: List[str] = dataclasses.field(default_factory=list)

    # --- TPU execution settings (no reference analog) ---
    # Skip contigs whose output directory already holds vartigs — the
    # per-contig elasticity the reference lacks (SURVEY.md §5
    # checkpoint/resume: per-contig output dirs are independent).
    resume: bool = False
    # Continue past per-contig failures instead of aborting the run.
    keep_going: bool = False
    # Contigs per device-batch group: realignment and block phasing of a
    # whole group share dispatches.
    contig_batch: int = 16
    # If set, use this many devices for block sharding; None = all local.
    num_devices: Optional[int] = None
    # Summary-TSV filename inside out_dir; multihost points each process
    # at its own file so concurrent appends never share a file.
    ploidy_tsv: str = "contig_ploidy_info.tsv"
    # Per-dispatch batch budget in read-site cells for the ploidy sweep
    # ("auto" probes the device link once: small cap on a local chip,
    # large on a high-latency link; or an explicit integer). Env
    # FLORIA_SWEEP_CAP_CELLS overrides both. Output-invariant either way
    # (phase/local.py:_plan).
    sweep_cap: str = "auto"

    def __post_init__(self) -> None:
        # Quantize epsilon onto the 2^-26 weight grid (phred weights are
        # exact multiples of 2^-26, kernels/beam.py _WEIGHT_SCALE). With
        # epsilon on the same grid, EVERY quantity in the distance /
        # MEC / beam-score arithmetic is an exact multiple of 2^-26 with
        # magnitude < 2^27, so f64 additions are exact and ORDER-FREE:
        # the reference's sequential f64 walks (utils_frags.rs:32-75,
        # global_clustering.rs:84-118) and this framework's vectorized
        # f64 reductions provably compute identical values. The shift is
        # < 7.5e-9 — below any measurable input-noise scale (the
        # reference's own auto-estimator quantizes epsilon to 1/500
        # pileup steps, file_reader.rs:749-826). See VALIDATION.md
        # "Exact arithmetic".
        # Near-zero epsilon (< 2^-27) would quantize to exactly 0 and
        # put log(eps) = -inf into the binomial tail; clamp to one
        # quantum instead so "no sequencing error" inputs degrade
        # gracefully (tests/test_robustness.py eps0) while validate()
        # keeps the strict eps > 0 kernel precondition.
        if self.epsilon >= 0.0:
            self.epsilon = max(round(self.epsilon * 67108864.0), 1) \
                / 67108864.0

    def validate(self) -> None:
        if not (0.0 < self.epsilon < 0.25):
            # The exactness argument needs epsilon < 0.25: its 2^-26
            # quanta then carry <= 24 significant bits, so the f32
            # epsilon arrays fed to the device kernels store the grid
            # value exactly (kernels/beam.py _WEIGHT_SCALE; advisor
            # round 4). Error rates >= 25% are nonsensical anyway.
            raise ValueError(
                f"epsilon must be in (0, 0.25), got {self.epsilon}")
        if not (1 <= self.ploidy_sensitivity <= 3):
            raise ValueError("ploidy sensitivity must be between 1 and 3")
        if self.max_ploidy < 1:
            raise ValueError("max ploidy must be >= 1")
        if self.sweep_cap != "auto":
            try:
                int(self.sweep_cap)
            except (TypeError, ValueError):
                raise ValueError(
                    "--sweep-cap must be 'auto' or an integer cell "
                    f"budget, got {self.sweep_cap!r}") from None
