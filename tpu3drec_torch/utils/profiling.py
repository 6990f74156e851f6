"""Tracing / profiling utilities.

Port of `tpu3drec/utils/profiling.py`:

- `Timer` / `span(...)`: named wall-clock spans collected into a
  `ProfileCollector` (per-stage timing in result metadata);
- `trace_to(dir)`: a `torch.profiler` trace of the CPU and, where there
  is one, the card, written into `dir` as a Chrome trace
  (`trace_<pid>_<n>.json`); a no-op where the profiler cannot start;
- `device_memory_stats()`: the card's allocator counters where there is
  a card, beside the host's RSS (psutil) and tracemalloc numbers.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
import tracemalloc
from collections import defaultdict
from pathlib import Path
from typing import Dict


class Timer:
    """Context-managed wall-clock timer."""

    def __init__(self):
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False


class ProfileCollector:
    """Accumulates named span durations; not thread-safe (the pipelines
    are single-threaded hosts driving asynchronous device work)."""

    def __init__(self):
        self.spans: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.spans.items():
            out[name] = {"count": len(xs), "total_s": sum(xs),
                         "mean_s": sum(xs) / len(xs)}
        return out

    def reset(self) -> None:
        self.spans.clear()


_GLOBAL = ProfileCollector()
_TRACES = itertools.count()


def span(name: str):
    """Global-collector span: `with span("detect"): ...`."""
    return _GLOBAL.span(name)


def global_summary() -> Dict:
    return _GLOBAL.summary()


@contextlib.contextmanager
def trace_to(log_dir: str):
    """`torch.profiler` trace of the enclosed work, exported as a Chrome
    trace into `log_dir`. Falls back to a no-op where the profiler cannot
    start or export."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = None
    try:
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception:
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                prof.__exit__(None, None, None)
                out = Path(log_dir)
                out.mkdir(parents=True, exist_ok=True)
                prof.export_chrome_trace(
                    str(out / f"trace_{os.getpid()}_{next(_TRACES)}.json"))
            except Exception:
                pass


def device_memory_stats() -> Dict:
    """The card's and the host's memory: `device_bytes_in_use`,
    `device_peak_bytes` and `device_limit_bytes` (the card's total) from
    the caching allocator where there is a card, `host_rss_bytes`, and
    the tracemalloc counters while tracemalloc traces."""
    out: Dict = {}
    try:
        import torch
        if torch.cuda.is_available():
            stats = torch.cuda.memory_stats()
            out["device_bytes_in_use"] = int(
                stats.get("allocated_bytes.all.current", 0))
            out["device_peak_bytes"] = int(
                stats.get("allocated_bytes.all.peak", 0))
            out["device_limit_bytes"] = int(
                torch.cuda.get_device_properties(0).total_memory)
    except Exception:
        pass
    try:
        import psutil
        out["host_rss_bytes"] = psutil.Process().memory_info().rss
    except Exception:
        pass
    if tracemalloc.is_tracing():
        cur, peak = tracemalloc.get_traced_memory()
        out["traced_current_bytes"] = cur
        out["traced_peak_bytes"] = peak
    return out
