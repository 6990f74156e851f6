"""knn2's share of its roofline over its own launches: the least time
the traced stretch's 2-NN work needs on the published peaks
(`trace/bounds.py`), the larger of the program's counted bytes over the
memory bandwidth and its counted products over the int8 and float32
rates, over the device time of the program's span `knn2.kernel`, which
holds the kernel's launch alone. The counts are the program's traced
view (`tpu3drec_torch/utils/profiling.py:counters`); None where the
program has no such counter or span."""

from recbench.trace.bounds import PEAK_BYTES_PER_S, PEAK_F32_OPS, PEAK_INT8_OPS


def _traced_counters():
    try:
        from tpu3drec_torch.utils.profiling import counters
    except ImportError:
        return None
    return counters(traced=True)


def read(ctx):
    dev_ms = ctx["trace"].device_ms("knn2.kernel")
    c = _traced_counters()
    if not c or "knn2.bytes" not in c or dev_ms <= 0:
        return None
    ops_s = (2.0 * c.get("knn2.macs.int8", 0) / PEAK_INT8_OPS
             + 2.0 * c.get("knn2.macs.f32", 0) / PEAK_F32_OPS)
    bound_ms = max(c["knn2.bytes"] / PEAK_BYTES_PER_S, ops_s) * 1e3
    return 100.0 * bound_ms / dev_ms
