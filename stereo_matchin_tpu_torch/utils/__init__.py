"""Shared utilities: device synchronisation, stage timing and tracing,
and the frames captured as CUDA graphs (graphs.replay, clear_caches)."""

from .graphs import clear_caches
from .profiling import Stopwatch, call_stage, device_sync, trace

__all__ = ["Stopwatch", "call_stage", "clear_caches", "device_sync", "trace"]
