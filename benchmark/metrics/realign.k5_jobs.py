"""realign.k5_jobs: per CLI job, the unique realignment jobs the program
hands to K5 (csrc/nw_best.cu), the `nw_jobs` counts of its
`realign.device.nw_best` spans."""

from harness.program_spans import count_per_job


def read(run):
    return count_per_job(run, "nw_jobs")
