"""Shared utilities: device synchronisation, stage timing and tracing."""

from .profiling import Stopwatch, call_stage, device_sync, trace

__all__ = ["Stopwatch", "call_stage", "device_sync", "trace"]
