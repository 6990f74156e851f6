"""Device ms per batch in the program's span `lightglue.cross`
(a layer's cross block), summed over its openings. None where the program has no such
span."""

SPAN = "lightglue.cross"


def read(ctx):
    tr = ctx["trace"]
    if not tr.count(SPAN):
        return None
    return tr.device_ms(SPAN) / ctx["batches"]
