"""api.upload_mb: per instance-API call, the megabytes (10^6 bytes) the
program hands to the card: the block caches' padded alleles and quals and
each dispatch's arguments, the `h2d_bytes` counts of the program's spans
(floria_tpu_torch.timing) inside the window."""

from harness.program_spans import count_per_job


def read(run):
    n = count_per_job(run, "h2d_bytes")
    return None if n is None else n / 1e6
