"""Device ms per batch in the program's span `aliked.select` (ALIKED's
NMS, top-k and DKD), summed over its openings. None where the program
has no such span."""

SPAN = "aliked.select"


def read(ctx):
    tr = ctx["trace"]
    if not tr.count(SPAN):
        return None
    return tr.device_ms(SPAN) / ctx["batches"]
