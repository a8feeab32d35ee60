"""Per-stage benchmark harness (the reference's TSV format)."""

from .harness import (
    ASW_COLUMNS,
    CROSS_COLUMNS,
    StageTimer,
    run_benchmark,
    time_asw_method,
    time_cross_method,
)

__all__ = [
    "ASW_COLUMNS",
    "CROSS_COLUMNS",
    "StageTimer",
    "run_benchmark",
    "time_asw_method",
    "time_cross_method",
]
