"""The independent oracle pipeline on the port: the dict/loop spec of the
reference's semantics that the device path is held to, on host numpy,
scipy's LP and the faithful C++ beam (`native.baseline_sweep`).

- `reference`: the local phasing algorithms (beam search, UPEM, MEC);
- `pipeline`: the per-contig flow after ingest and the output texts;
- `ingest`: one contig's fragments read as the pipeline reads them.

It runs no kernel. `run_contig` is the whole of it on one contig, as
`python -m floria_tpu_torch.scripts.oracle_e2e_baseline` times it on one
core and chip_smoke.py's `oracle` phase holds the card's outputs to it.
"""

from __future__ import annotations

import time

from .ingest import contig_length, oracle_inputs
from .pipeline import contig_texts, phase_contig


def run_contig(opts, contig: str, *, device, use_native: bool = True):
    """The oracle on `contig` of `opts`' inputs: ingest (realignment's
    device NW partitions on `device`), phase_contig, then the four texts
    the CLI writes (the contig directory as `pipeline.CDIR`). Returns
    (texts, phased five-tuple, {"ingest": s, "phase": s, "texts": s})."""
    t0 = time.perf_counter()
    frags, short_frags, combined, cv = oracle_inputs(opts, contig,
                                                     device=device)
    t1 = time.perf_counter()
    phased = phase_contig(frags, cv.genome_pos, opts, use_native=use_native,
                          short_frags=short_frags)
    t2 = time.perf_counter()
    texts = contig_texts(phased, combined, cv.genome_pos, contig,
                         contig_length(opts.reference_fasta, contig))
    seconds = {"ingest": t1 - t0, "phase": t2 - t1,
               "texts": time.perf_counter() - t2}
    return texts, phased, seconds
