"""The run's guards: the card it needs, and no JAX in the process."""

from __future__ import annotations

import subprocess
from typing import Iterable, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "floria_tpu")


def forbidden_modules(modules: Iterable[str]) -> List[str]:
    """The loaded modules whose top-level name (the part before the first
    dot) is one of FORBIDDEN, compared whole: `floria_tpu_torch` is not
    `floria_tpu`."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)


def card_error(chips: int) -> Optional[str]:
    """Why this machine cannot run a cell on `chips` cards, or None."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is False: the benchmark needs a card"
    if torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} cards and "
                f"{torch.cuda.device_count()} are visible")
    return None


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def device_info(dev, peak: int) -> dict:
    import torch

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": peak}
