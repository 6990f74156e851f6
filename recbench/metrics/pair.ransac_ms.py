"""Device ms per batch in the program's range `pair_step.ransac`."""

RANGE = "pair_step.ransac"


def read(ctx):
    tr = ctx["trace"]
    n = tr.count(RANGE)
    return tr.device_ms(RANGE) / n if n else None
