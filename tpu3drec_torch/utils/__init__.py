"""Timing spans, device traces and memory snapshots."""

from tpu3drec_torch.utils.profiling import (
    Timer, span, ProfileCollector, device_memory_stats, trace_to,
)
