"""api_reads_per_s: reads of every instance-API call of the window, each
block's reads once a call, over the window's wall time (host clock)."""


def read(run):
    reads = run.counters.get("api.reads")
    return None if reads is None else reads / run.window_s
