"""Device ms per batch in the program's span `aliked.deform` (each of
ALIKED's four deformable convolutions, inside the backbone), summed
over its openings. None where the program has no such span."""

SPAN = "aliked.deform"


def read(ctx):
    tr = ctx["trace"]
    if not tr.count(SPAN):
        return None
    return tr.device_ms(SPAN) / ctx["batches"]
