"""api.phase_ms: per instance-API call, the wall time of `phase_instances`,
which ends with its results on the host (the harness's span)."""


def read(run):
    walls = run.span_walls("api.phase")
    return sum(walls) / len(walls) * 1e3 if walls else None
