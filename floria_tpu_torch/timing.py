"""Per-stage wall-time accumulator, shared with the reference.

floria_tpu/timing.py is host-only; the port's pipeline adds its stage
spans to the same process-global dict, re-exported here for callers of
the port. `pipeline.run()` resets it at entry.
"""

from floria_tpu.timing import STAGE_TIMES, add, reset  # noqa: F401
