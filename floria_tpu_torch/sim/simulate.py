"""The community simulator, shared with the reference as it is.

floria_tpu/sim/simulate.py is host numpy and imports no jax; it is
re-exported here so callers of the port (chip_smoke.py, benchmarks)
reach it through the port's own modules.
"""

from floria_tpu.sim.simulate import SimConfig, simulate  # noqa: F401
