"""Host worker-thread budget shared by every parallel host stage.

The reference sizes ONE global rayon pool from `-t` and every parallel
site scales with it (parse_cmd_line.rs:153-156; file_reader.rs:388-437;
utils_frags.rs:509-564). This module is that budget's equivalent: the
CLI/pipeline sets it once from Options.num_threads, and the native
multithreaded loops (floria_tpu/native.py) plus the host launch/pull
pools (phase/local.py) size themselves from it. Default (unset): all
visible cores, matching the prior hard-coded os.cpu_count() behavior.
"""

from __future__ import annotations

import os
from typing import Optional

_NUM_THREADS: Optional[int] = None


def set_num_threads(n: Optional[int]) -> None:
    """Set the host worker budget (None restores the all-cores
    default). Values < 1 clamp to 1."""
    global _NUM_THREADS
    _NUM_THREADS = None if n is None else max(1, int(n))


def num_threads() -> int:
    """Current host worker budget."""
    if _NUM_THREADS is not None:
        return _NUM_THREADS
    return os.cpu_count() or 1
