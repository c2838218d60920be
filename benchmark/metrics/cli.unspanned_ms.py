"""cli.unspanned_ms: per CLI job, the time inside `cli.main` and
`pipeline.run` that no span under them on their own thread holds (their
self time, from the program's spans, floria_tpu_torch.timing)."""

from harness.program_spans import self_ms


def read(run):
    return self_ms(run, ("cli.main", "pipeline.run"))
