"""Shared utilities: device synchronisation, stage timing and tracing,
and the frames and stages captured as CUDA graphs (graphs.replay,
replay_stage, clear_caches)."""

from .graphs import clear_caches, replay_stage
from .profiling import Stopwatch, call_stage, device_sync, trace

__all__ = ["Stopwatch", "call_stage", "clear_caches", "device_sync",
           "replay_stage", "trace"]
