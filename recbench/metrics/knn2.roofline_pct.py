"""knn2's share of its roofline: the least time the traced batches'
own 2-NN operands need on the published peaks (`trace/bounds.py`), over
the device time of the program's range `pair_step.match` around them."""

from recbench.trace.bounds import knn2_bound_ms


def read(ctx):
    ops = ctx.get("knn2")
    dev_ms = ctx["trace"].device_ms("pair_step.match")
    if not ops or dev_ms <= 0:
        return None
    return 100.0 * sum(knn2_bound_ms(*o) for o in ops) / dev_ms
