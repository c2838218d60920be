"""api.cache_ms: per instance-API call, the time of the two block caches'
packing and upload (`phase_instances`' and `refine_instances'`): the
program's `beam.cache_upload` spans (floria_tpu_torch.timing) inside the
window."""

from harness.program_spans import span_ms


def read(run):
    return span_ms(run, ("beam.cache_upload",))
