"""Device ms per batch in the program's span `aliked.backbone` (ALIKED's
blocks 1-4), summed over its openings. None where the program has no
such span."""

SPAN = "aliked.backbone"


def read(ctx):
    tr = ctx["trace"]
    if not tr.count(SPAN):
        return None
    return tr.device_ms(SPAN) / ctx["batches"]
