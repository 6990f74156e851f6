"""The device's idle share of the traced stretch: 1 minus the union of
the device operations' intervals over the stretch, in %."""


def read(ctx):
    tr = ctx["trace"]
    if tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
