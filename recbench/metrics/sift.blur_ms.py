"""Device ms per batch in the program's span `sift.blur` (the base blur or the octave's decimation, then its Gaussian pyramid),
opened once per octave. None where the program has no such span."""

SPAN = "sift.blur"


def read(ctx):
    tr = ctx["trace"]
    if not tr.count(SPAN):
        return None
    return tr.device_ms(SPAN) / ctx["batches"]
