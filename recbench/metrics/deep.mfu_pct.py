"""The deep pair step's model-FLOP share: SuperPoint's and LightGlue's
model FLOPs for the traced batches (`trace/deep_work.py`), over the
traced stretch's wall time at the dense TF32 peak. None without
recorded operands or without device work (a run on no card)."""

from recbench.trace.deep_work import PEAK_TF32_OPS, batch_flops


def read(ctx):
    ops = ctx.get("deep")
    tr = ctx["trace"]
    if not ops or tr.busy_s <= 0 or tr.window_s <= 0:
        return None
    flops = sum(sum(batch_flops(o)) for o in ops)
    return 100.0 * flops / (tr.window_s * PEAK_TF32_OPS)
