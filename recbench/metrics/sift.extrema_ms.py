"""Device ms per batch in the program's span `sift.extrema` (the DoG, its 3x3x3 extrema, the candidate score and top-k),
opened once per octave. None where the program has no such span."""

SPAN = "sift.extrema"


def read(ctx):
    tr = ctx["trace"]
    if not tr.count(SPAN):
        return None
    return tr.device_ms(SPAN) / ctx["batches"]
