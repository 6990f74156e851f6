"""Reads a stretch of the device's work from the profiler's raw events.

A copy of `chip_smoke.py:profile_call`'s reader, which takes the raw
events (`prof.profiler.kineto_results.events()`) and not
`key_averages()`, which builds the whole event tree first. A host
range's device time is the summed time of the device operations that
were launched on its thread while it was open, matched by the launch's
correlation id, so kernels launched through ctypes count too. The
device's busy time is the union of the device operations' intervals
within the window, not their sum.
"""

from __future__ import annotations

import bisect
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

WINDOW_RANGE = "recbench.window"
# a host range of the program or the benchmark (`pair_step.detect`,
# `dense.sgm`, `recbench.batch`), should a build not flag it as a user
# annotation
_SPAN = re.compile(r"^[a-z_0-9]+\.[a-z_0-9.]+$")


@dataclass
class Trace:
    window_s: float
    busy_s: float
    # range name -> [count, host ms, device ms]
    ranges: Dict[str, List[float]] = field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def count(self, name: str) -> int:
        return int(self.ranges.get(name, [0, 0.0, 0.0])[0])

    def device_ms(self, name: str) -> float:
        return self.ranges.get(name, [0, 0.0, 0.0])[2]


def profile(torch, fn: Callable[[], None], device: str) -> Trace:
    """Runs `fn` once under the profiler, inside the window range, and
    reads the trace (on a CPU device, host events only)."""
    from torch.profiler import ProfilerActivity, profile as _profile
    from torch.profiler import record_function
    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with _profile(activities=activities) as prof:
        with record_function(WINDOW_RANGE):
            fn()
            if cuda:
                torch.cuda.synchronize()
    return read_events(prof.profiler.kineto_results.events())


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_events(events) -> Trace:
    from torch.autograd import DeviceType
    launch, device, spans = {}, [], []
    for ev in events:
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation():
                device.append((ev.correlation_id(), ev.start_ns(),
                               ev.duration_ns(), name))
        elif ev.is_user_annotation() or _SPAN.match(name):
            spans.append((name, ev.start_thread_id(), ev.start_ns(),
                          ev.duration_ns()))
        elif name.startswith("cu"):
            # a runtime or driver call (cudaLaunchKernel, cuLaunchKernel,
            # cudaMemcpyAsync, ...): its correlation id names its device op
            launch[ev.correlation_id()] = (ev.start_thread_id(),
                                           ev.start_ns())
    win = [s for s in spans if s[0] == WINDOW_RANGE]
    if not win:
        raise RuntimeError("trace: the window range is missing")
    _, win_tid, w0, wdur = win[0]
    w1 = w0 + wdur

    # device time of each host range: ops launched on its thread while
    # it was open, by launch time, with running sums
    by_thread: Dict[int, list] = {}
    for corr, _, ns, _ in device:
        if corr in launch:
            tid, at = launch[corr]
            by_thread.setdefault(tid, []).append((at, ns))
    cum = {}
    for tid, rows in by_thread.items():
        rows.sort()
        sums = [0]
        for _, ns in rows:
            sums.append(sums[-1] + ns)
        cum[tid] = ([at for at, _ in rows], sums)
    ranges: Dict[str, List[float]] = {}
    for name, tid, start, ns in spans:
        at, sums = cum.get(tid, ([], [0]))
        lo = bisect.bisect_left(at, start)
        hi = bisect.bisect_right(at, start + ns)
        r = ranges.setdefault(name, [0, 0.0, 0.0])
        r[0] += 1
        r[1] += ns / 1e6
        r[2] += (sums[hi] - sums[lo]) / 1e6

    # busy: the union of the device ops' intervals inside the window
    busy = _union([(max(s, w0), min(s + ns, w1)) for _, s, ns, _ in device
                   if s < w1 and s + ns > w0])
    busy_ns = sum(e - s for s, e in busy)

    by_name: Dict[str, float] = {}
    for _, _, ns, name in device:
        by_name[name] = by_name.get(name, 0.0) + ns / 1e9
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    # idle gaps inside the window, named by the innermost range of the
    # window's thread that was open at the gap's middle
    inner = [s for s in spans if s[1] == win_tid and s[0] != WINDOW_RANGE]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps: Dict[str, float] = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        open_ = [s for s in inner if s[2] <= mid <= s[2] + s[3]]
        name = min(open_, key=lambda s: s[3])[0] if open_ else "(no range)"
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e9
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return Trace(window_s=wdur / 1e9, busy_s=busy_ns / 1e9, ranges=ranges,
                 device_ops=device_ops, idle_gaps=idle)
