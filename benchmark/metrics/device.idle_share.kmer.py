"""Share of the traced window in which no kernel, copy or set of the
program ran on the card, in percent, in the per-k-mer cell of the 20k
library."""


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr.get("window_s") or not tr.get("busy_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
