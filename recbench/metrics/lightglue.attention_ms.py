"""Device ms per batch in the program's span `lightglue.attention`
(each masked-attention call of the self and cross blocks), summed over its
openings. None where the program has no such span."""

SPAN = "lightglue.attention"


def read(ctx):
    tr = ctx["trace"]
    if not tr.count(SPAN):
        return None
    return tr.device_ms(SPAN) / ctx["batches"]
