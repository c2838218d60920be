"""api.window_ms: per instance-API call, the time of the dispatch windows
worked out and checked on the host before the launches: the program's
`dispatch.window` spans (floria_tpu_torch.timing) inside the window."""

from harness.program_spans import span_ms


def read(run):
    return span_ms(run, ("dispatch.window",))
