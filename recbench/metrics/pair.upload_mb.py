"""MB per batch of host constants copied to the device during the traced
stretch: the program's counter `upload.bytes` in its traced view
(`tpu3drec_torch/utils/profiling.py:counters`) over the batches. None
where the program has no such counter."""


def _traced_counters():
    try:
        from tpu3drec_torch.utils.profiling import counters
    except ImportError:
        return None
    return counters(traced=True)


def read(ctx):
    c = _traced_counters()
    if not c or "upload.bytes" not in c:
        return None
    return c["upload.bytes"] / 1e6 / ctx["batches"]
