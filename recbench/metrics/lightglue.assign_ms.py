"""Device ms per batch in the program's span `lightglue.assign`
(the assignment head and the mutual, gated matches), summed over its openings. None where the program has no such
span."""

SPAN = "lightglue.assign"


def read(ctx):
    tr = ctx["trace"]
    if not tr.count(SPAN):
        return None
    return tr.device_ms(SPAN) / ctx["batches"]
