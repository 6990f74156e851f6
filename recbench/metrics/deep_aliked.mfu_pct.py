"""The ALIKED deep pair step's model-FLOP share: the least time of the
traced batches' model work (ALIKED's FLOPs at the float32 peak plus
LightGlue's at the dense TF32 peak; `trace/aliked_work.py`), over the
traced stretch's wall time. None without recorded operands or without
device work (a run on no card)."""

from recbench.trace.aliked_work import least_s


def read(ctx):
    ops = ctx.get("deep")
    tr = ctx["trace"]
    if not ops or tr.busy_s <= 0 or tr.window_s <= 0:
        return None
    return 100.0 * sum(least_s(o) for o in ops) / tr.window_s
