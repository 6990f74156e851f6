"""Device ms per batch in the program's span `aliked.sddh` (ALIKED's
sparse deformable descriptor head), summed over its openings. None
where the program has no such span."""

SPAN = "aliked.sddh"


def read(ctx):
    tr = ctx["trace"]
    if not tr.count(SPAN):
        return None
    return tr.device_ms(SPAN) / ctx["batches"]
