"""Nanoseconds of the `intersect_class_bits` kernel in the traced window
(its records under `layers/kernels.json`'s wrapper) per read of the jobs
that did not fail: the class-bits intersection at W = 625 over every
matched k-mer window's class id."""


def read(rec):
    tr = rec.get("trace")
    reads = sum(j["reads"] for j in rec["jobs"] if not j["failed"])
    s = (tr or {}).get("kernel_s", {}).get("intersect_class_bits")
    if not s or not reads:
        return None
    return s * 1e9 / reads
