"""LightGlue's share of its roofline: the least time the traced
batches' own LightGlue work needs on the published peaks (its counted
FLOPs at the dense TF32 rate, or its least bytes at the memory
bandwidth, the larger; `trace/deep_work.py`), over the device time of
the program's range `pair_step.match` around it. None without recorded
operands or device time."""

from recbench.trace.deep_work import lightglue_bound_ms


def read(ctx):
    ops = ctx.get("deep")
    dev_ms = ctx["trace"].device_ms("pair_step.match")
    if not ops or dev_ms <= 0:
        return None
    return 100.0 * sum(lightglue_bound_ms(o) for o in ops) / dev_ms
