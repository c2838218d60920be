"""realign.k5_ms: per CLI job, the milliseconds of the program's
`realign.device.nw_best` spans: K5 (csrc/nw_best.cu) as the host sees it,
its uploads, launch and pull of the calls."""

from harness.program_spans import span_ms


def read(run):
    return span_ms(run, ("realign.device.nw_best",))
