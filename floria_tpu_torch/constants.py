"""Algorithm tuning constants.

Parity with the reference implementation's compile-time constants
(the reference's src/constants.rs:3-24). Constants controlling disabled code
paths (WEIRD_SPLIT, MERGE_SIMILAR_HAPLOGROUPS) are kept so the corresponding
features can be toggled, matching the reference defaults.
"""

# Maximum UPEM hill-climb iterations (constants.rs:3).
NUM_ITER_OPTIMIZE = 20

# Minimum unambiguous shared-read count for a hap-graph edge to be kept, and
# minimum LP flow for a path edge (constants.rs:4).
MIN_SHARED_READS_UNAMBIG = 2.0

# Sample-size shrink divisor for the binomial tail score (constants.rs:5).
DIV_FACTOR = 0.25

# Posterior cutoff for beam-search branch pruning (constants.rs:6).
PROB_CUTOFF = 0.01

# Minimum HAPQ for haploset read output (constants.rs:10).
HAPQ_CUTOFF = 0

# Interval-overlap fraction above which haplogroups are merge candidates
# (constants.rs:11).
MERGE_CUTOFF = 0.95

# (constants.rs:13) — density guard, present for parity.
SAME_SNP_DENSITY_CUTOFF = 1.0 / 10000.0

# Coverage floor used when comparing haplotype consensus sequences
# (constants.rs:14).
DIST_COV_CUTOFF = 0.5

# Weight alleles by phred-derived correctness probability (constants.rs:15).
USE_QUAL_SCORES = True

# Post-processing feature switches (constants.rs:16-18). Defaults match the
# reference: only broken-haplogroup separation is active.
MERGE_SIMILAR_HAPLOGROUPS = False
SEPARATE_BROKEN_HAPLOGROUPS = True
WEIRD_SPLIT = False

# (constants.rs:19) — unused multiplier kept for parity.
FLOW_CUTOFF_MULT = 100.0

# HAPQ scale factor (constants.rs:20).
HAPQ_CONSTANT = 40.0

# Minimum auto-estimated block length in bp (constants.rs:21).
MINIMUM_BLOCK_SIZE = 500

# Extra bases kept when trimming output reads to SNP ranges (constants.rs:22).
EXTENSION_BASES = 25

# Header for the per-contig strain-count summary (constants.rs:24).
CONTIG_PLOIDY_HEADER = (
    "contig\taverage_straincount\twhole_contig_multiplicity\t"
    "approximate_coverage_ignoring_indels\ttotal_vartig_bases_covered\t"
    "average_straincount_min15hapq\taverage_straincount_min30hapq\t"
    "average_straincount_min45hapq\tavg_err\n"
)

# Sentinel allele value for gaps in legacy fragment files
# (types_structs.rs:16).
GAP_CHAR = 9

# Maximum distinct alleles at a SNP site. VCF records are filtered to
# single-base A/C/G/T alleles (file_reader.rs:288-302), so at most four.
MAX_ALLELES = 4

# Reads spanning more than this many SNPs are treated as circular-mapping
# artifacts and skipped during block clustering (local_clustering.rs:44).
MAX_SNP_SPAN = 10000

# Beam search keeps ploidy * beam_width solutions for the first this-many
# reads of a block (global_clustering.rs:50-55).
BEAM_WARMUP_READS = 25

# SNP-window used for broken-block detection during beam truncation
# (types_structs.rs:343-353).
BREAK_LOOKBACK_SNPS = 50
