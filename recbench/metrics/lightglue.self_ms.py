"""Device ms per batch in the program's span `lightglue.self`
(a layer's self blocks on both views), summed over its openings. None where the program has no such
span."""

SPAN = "lightglue.self"


def read(ctx):
    tr = ctx["trace"]
    if not tr.count(SPAN):
        return None
    return tr.device_ms(SPAN) / ctx["batches"]
