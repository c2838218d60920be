"""cli_reads_per_s: input reads of every CLI job of the window, as the
generator counted them, over the window's wall time (host clock)."""


def read(run):
    reads = run.counters.get("cli.reads")
    return None if reads is None else reads / run.window_s
