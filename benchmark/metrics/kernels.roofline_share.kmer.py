"""`kmer_keys`' share of its roofline in the traced window of the
per-k-mer cell: the least time its counted bytes need at 3.35 TB/s
(kernel_bytes.py on each launch's own arguments: k = 21 over rows of
112 bases, 92 windows, of which a 100 bp read fills 80) over the
kernel's own time in the trace, in percent. The cell's other hand
kernel, `intersect_class_bits`, has no byte count."""
from benchmark.kernel_bytes import bound_s


def read(rec):
    tr = rec.get("trace") or {}
    s, n = tr.get("kernel_s", {}).get("kmer_keys"), tr.get("kernel_bytes", {}).get("kmer_keys")
    if not s or not n:
        return None
    return 100.0 * bound_s(n) / s
