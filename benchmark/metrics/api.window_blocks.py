"""api.window_blocks: per instance-API call, the blocks whose read columns
the dispatch windows read: the `window_blocks` counts of the program's
`dispatch.window` spans (floria_tpu_torch.timing) inside the window. A
block read once serves every later dispatch of the call; a dispatch stops
at the first block that rules a window out."""

from harness.program_spans import count_per_job


def read(run):
    return count_per_job(run, "window_blocks")
