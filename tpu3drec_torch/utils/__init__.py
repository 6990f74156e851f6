"""Profiler spans, counters, device traces and memory snapshots."""

from tpu3drec_torch.utils.profiling import (
    Timer, span, count, counters, reset_counters, upload, ProfileCollector,
    device_memory_stats, trace_to,
)
