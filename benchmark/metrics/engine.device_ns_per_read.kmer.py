"""Nanoseconds of card activity (kernels, copies, sets the program
launched, from the profiler's trace) in the traced window per read of
the jobs that did not fail, on the per-k-mer path."""


def read(rec):
    tr = rec.get("trace")
    reads = sum(j["reads"] for j in rec["jobs"] if not j["failed"])
    if not tr or not tr.get("busy_s") or not reads:
        return None
    return tr["busy_s"] * 1e9 / reads
