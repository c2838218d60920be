"""api.unspanned_ms: per instance-API call, the time inside
`phase_instances` and `refine_instances` that no span under them on
their own thread holds (their self time, from the program's spans,
floria_tpu_torch.timing)."""

from harness.program_spans import self_ms


def read(run):
    return self_ms(run, ("phase_instances", "refine_instances"))
