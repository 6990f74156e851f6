"""Device ms per batch in the program's span `sift.select` (each octave's parts, then the merge, the global top-K and the padding),
opened once per octave. None where the program has no such span."""

SPAN = "sift.select"


def read(ctx):
    tr = ctx["trace"]
    if not tr.count(SPAN):
        return None
    return tr.device_ms(SPAN) / ctx["batches"]
