"""Device ms per batch in the program's span `sift.refine` (subpixel refinement through the kernel's meta, with the gradient stacks),
opened once per octave. None where the program has no such span."""

SPAN = "sift.refine"


def read(ctx):
    tr = ctx["trace"]
    if not tr.count(SPAN):
        return None
    return tr.device_ms(SPAN) / ctx["batches"]
