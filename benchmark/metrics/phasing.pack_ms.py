"""phasing.pack_ms: per CLI job, the time of the sweep's block packing
(ranges, reads in each, packed tensors): the program's `phase.pack` spans
(floria_tpu_torch.timing) inside the window."""

from harness.program_spans import span_ms


def read(run):
    return span_ms(run, ("phase.pack",))
