"""The hand kernels' share of their roofline in the traced window: the
least time the bytes of every counted launch need at 3.35 TB/s
(kernel_bytes.py) over the kernels' own time in the trace, in percent.
Only kernels whose bytes are counted enter either sum."""
from benchmark.kernel_bytes import bound_s


def read(rec):
    tr = rec.get("trace")
    if not tr:
        return None
    counted = [k for k in tr["kernel_bytes"] if tr["kernel_s"].get(k)]
    device_s = sum(tr["kernel_s"][k] for k in counted)
    if device_s <= 0:
        return None
    return 100.0 * sum(bound_s(tr["kernel_bytes"][k]) for k in counted) / device_s
