"""Tracing / profiling utilities.

Port of `tpu3drec/utils/profiling.py`, with the port's one span API and
one counter registry:

- `span(name)`: a `torch.profiler.record_function` range while a
  profiler session records, else a shared null context. The range is a
  kineto user annotation on the profiler's clock, so a trace reader can
  put each device op and idle gap down to the innermost open span. With
  no profiler recording it costs one flag read (~0.35 us a span on a
  CPU, where an idle `record_function` costs ~10 us);
- `count(name, n, per, plus)`, `counters()`, `reset_counters()`: named
  counts in two views. Process totals count every host integer, always. The
  traced view holds what was counted while a profiler recorded, and
  starts again from zero at the first count of a new session; a count
  whose value is a device tensor enters only that view and is read back
  only by `counters(traced=True)`, so no count launches a kernel or
  synchronises while nothing records;
- `upload(host, device)`: a host constant copied to a tensor on
  `device`, counted as `upload.copies` and `upload.bytes` whatever the
  device;
- `Timer` and `ProfileCollector`: wall-clock timing of named spans;
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
import threading
import time
import tracemalloc
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Tuple

import torch
from torch.autograd import _profiler_enabled as recording
from torch.profiler import record_function

_NULL = contextlib.nullcontext()


class Counters:
    """Named counts in two views (see the module docstring). A profiler
    session is told from the one before by the registry seeing no
    profiler in between, at a span, a count or a read."""

    def __init__(self):
        self._lock = threading.Lock()
        self._total: Dict[str, int] = {}
        self._traced: Dict[str, int] = {}
        # the traced view's device-valued counts (name, n, per, plus),
        # read back only when the view is read
        self._pending: List[Tuple[str, torch.Tensor, int, int]] = []
        self.session_over = True

    def count(self, name: str, n=1, per: int = 1, plus: int = 0) -> None:
        if recording():
            self._count_recorded(name, n, per, plus)
            return
        self.session_over = True
        if type(n) is not int and isinstance(n, torch.Tensor):
            return
        with self._lock:
            self._total[name] = self._total.get(name, 0) + n * per + plus

    def _count_recorded(self, name: str, n, per: int, plus: int) -> None:
        with self._lock:
            if self.session_over:
                self.session_over = False
                self._traced.clear()
                self._pending.clear()
            if isinstance(n, torch.Tensor):
                self._pending.append((name, n.detach(), per, plus))
                return
            v = n * per + plus
            self._traced[name] = self._traced.get(name, 0) + v
            self._total[name] = self._total.get(name, 0) + v

    def read(self, traced: bool = False) -> Dict[str, int]:
        """A copy of the process totals, or of the traced view with its
        device-valued counts read back."""
        if not recording():
            self.session_over = True
        with self._lock:
            if not traced:
                return dict(self._total)
            out = dict(self._traced)
            pending = list(self._pending)
        for name, n, per, plus in pending:
            out[name] = out.get(name, 0) + int(n) * per + plus
        return out

    def reset(self) -> None:
        with self._lock:
            self._total.clear()
            self._traced.clear()
            self._pending.clear()
            self.session_over = True


_COUNTERS = Counters()


def span(name: str):
    """`with span("sift.blur"): ...`: a profiler range while a profiler
    records, else nothing."""
    if recording():
        return record_function(name)
    _COUNTERS.session_over = True
    return _NULL


def count(name: str, n=1, per: int = 1, plus: int = 0) -> None:
    """Adds `n * per + plus` to the counter `name`: `n` a host integer, or
    a device tensor, counted only while a profiler records and read back
    (`n` as an int64 scalar) when the traced view is read."""
    _COUNTERS.count(name, n, per, plus)


def counters(traced: bool = False) -> Dict[str, int]:
    """The process totals, or with `traced` the counts of the newest
    profiler session."""
    return _COUNTERS.read(traced)


def reset_counters() -> None:
    _COUNTERS.reset()


def upload(host, device, dtype=None) -> torch.Tensor:
    """`host` (a numpy array, list or number) as a new tensor on `device`:
    one host-to-device copy on a card, counted as `upload.copies` and
    `upload.bytes` on any device."""
    out = torch.tensor(host, dtype=dtype, device=device)
    _COUNTERS.count("upload.copies")
    _COUNTERS.count("upload.bytes", out.nbytes)
    return out


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


_TRACES = itertools.count()


@contextlib.contextmanager
def trace_to(log_dir: str):
    """`torch.profiler` trace of the enclosed work, exported as a Chrome
    trace into `log_dir`. Falls back to a no-op where the profiler cannot
    start or export."""
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
