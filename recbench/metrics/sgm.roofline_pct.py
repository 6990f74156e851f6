"""sgm's share of its roofline: the least time the traced run's cost
volumes need on the published peaks (read once, aggregate written once,
`trace/bounds.py`), over the device time of the program's ranges
`dense.sgm`."""

from recbench.trace.bounds import sgm_bound_ms


def read(ctx):
    n = ctx.get("sgm_elements")
    dev_ms = ctx["trace"].device_ms("dense.sgm")
    if not n or dev_ms <= 0:
        return None
    return 100.0 * sgm_bound_ms(n) / dev_ms
