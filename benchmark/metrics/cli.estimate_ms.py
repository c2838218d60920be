"""cli.estimate_ms: per CLI job, the time of the -e/-l estimation pass:
the program's `cli.estimate` spans (floria_tpu_torch.timing) inside the
window."""

from harness.program_spans import span_ms


def read(run):
    return span_ms(run, ("cli.estimate",))
