"""Device ms per batch in the program's span `sift.ori_desc` (the orientation and descriptor sampler with the descriptor normalisation),
opened once per octave. None where the program has no such span."""

SPAN = "sift.ori_desc"


def read(ctx):
    tr = ctx["trace"]
    if not tr.count(SPAN):
        return None
    return tr.device_ms(SPAN) / ctx["batches"]
