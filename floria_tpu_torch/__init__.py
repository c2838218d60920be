"""floria_tpu_torch — the floria-tpu phasing main path in PyTorch.

A second package beside the JAX reference `floria_tpu`. Host stages
(ingest, fragment finalize, block packing, hap-graph, LP, paths,
post-processing and writers) are imported from `floria_tpu`'s numpy/C++
modules as they are; the device part of the main path (the adaptive
ploidy sweep: beam scan, traceback, UPEM hill-climb, MEC stats) runs on
torch tensors, with two hand-written CUDA kernels for Hopper
(csrc/beam_scan.cu, csrc/upem_moves.cu). Every count, distance and
score is an exact integer number of 2^-26 weight quanta held in int64
or f64, so the port is bitwise equal to the reference.

This package never imports jax. `floria_tpu/__init__.py` tries to load
jax (to configure its compilation cache and x64 mode, which its host
modules do not use); when the port is the first to import
`floria_tpu`, that attempt is refused here, so no jax module is loaded.

Import order, in a process that also runs the JAX reference (an A/B
script, the test suite): import `jax` or `floria_tpu` BEFORE this
package. The refusal then does not apply and `floria_tpu` initialises
as it always does. Imported the other way round, `floria_tpu` stays
initialised without x64, and the reference's device kernels raise in
their x64 check. tests/conftest.py imports jax first.
"""

import sys as _sys

__version__ = "0.1.0"


class _RefuseJax:
    """Meta-path finder refusing `jax` while floria_tpu's package init
    runs (the init catches the ImportError)."""

    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax."):
            raise ImportError("floria_tpu_torch does not import jax")
        return None


# Only in a process that has loaded neither: once jax is loaded, refusing
# it gains nothing and would leave floria_tpu half-configured.
if "floria_tpu" not in _sys.modules and "jax" not in _sys.modules:
    _finder = _RefuseJax()
    _sys.meta_path.insert(0, _finder)
    try:
        import floria_tpu  # noqa: F401,E402
    finally:
        _sys.meta_path.remove(_finder)

from .device import require_no_tf32, resolve_device  # noqa: F401,E402

require_no_tf32()
