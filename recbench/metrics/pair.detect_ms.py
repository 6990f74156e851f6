"""Device ms per batch in the program's range `pair_step.detect`."""

RANGE = "pair_step.detect"


def read(ctx):
    tr = ctx["trace"]
    n = tr.count(RANGE)
    return tr.device_ms(RANGE) / n if n else None
