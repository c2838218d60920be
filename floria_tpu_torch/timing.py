"""Per-stage wall-time accumulator for the pipeline.

The reference logs stage spans ad hoc (floria.rs:204-206, 319-342);
here the same spans are additionally accumulated in a process-global
dict so tooling (bench.py) can report an end-to-end breakdown without
scraping logs. `run()` resets it at entry; values are cumulative
seconds across contig groups within one run.
"""

from typing import Dict

STAGE_TIMES: Dict[str, float] = {}


def reset() -> None:
    STAGE_TIMES.clear()


def add(stage: str, seconds: float) -> None:
    STAGE_TIMES[stage] = STAGE_TIMES.get(stage, 0.0) + seconds
