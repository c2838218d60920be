"""kernels.cli.device_ms: per CLI job, the device time of the CUDA
kernels the window ran (the profiler's trace; copies left out)."""


def read(run):
    if run.trace is None or not run.jobs:
        return None
    return sum(run.trace.kernel_s.values()) / run.jobs * 1e3
