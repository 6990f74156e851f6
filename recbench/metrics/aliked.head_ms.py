"""Device ms per batch in the program's span `aliked.head` (ALIKED's
per-level convolutions, the upsampling into the map, the score head
and the normalisation), summed over its openings. None where the
program has no such span."""

SPAN = "aliked.head"


def read(ctx):
    tr = ctx["trace"]
    if not tr.count(SPAN):
        return None
    return tr.device_ms(SPAN) / ctx["batches"]
