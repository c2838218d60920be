"""The benchmark of floria_tpu_torch, the PyTorch and CUDA port of
floria-tpu, on one or more NVIDIA cards. Run from the root of a checkout:

    python3 benchmark/run.py --workload config4.cli --seed 1 --seconds 51 \
        --trace 0
    python3 benchmark/run.py --workload ecoli2.blocks --seed 1 --seconds 51 \
        --trace 0

`--trace 0` prints the cell's end-to-end metrics (BENCHMARK.json
`end_to_end`); `--trace 1` runs the same window under the profiler and
prints the cell's per-layer metrics (`per_layer`) and the trace's
breakdown. The last line of standard output is one JSON object:
correct, attempted, failed, metrics, device, breakdown (traced runs) and
checks (each number compared with the plain reference, beside its limit);
the last lines of standard error repeat the checks.

A cell (`workloads`) names a configuration (`configs`: its file under
configs/) and a traffic mix (traffic/<name>.json, which names its driver
in harness/drivers/); each metric is read by metrics/<name>.py. A new
cell, configuration, traffic mix or metric is new files and manifest
entries; nothing here names one.

The run needs `torch.cuda.is_available()` and as many cards as the cell
asks for, and exits non-zero without a result otherwise, or if a module
of JAX or of the JAX package (floria_tpu) is loaded at the end. Inputs
are made from --seed in every run's set-up (the cli traffic's
communities under TMPDIR, removed at exit); the program's kernels build
into build/ of the checkout on the first run there.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

from harness import runner  # noqa: E402

if __name__ == "__main__":
    sys.exit(runner.main(sys.argv[1:], T_START))
