"""Reads of every job in the window over the window's wall, from the first
job's start to the last job's end; each job's index and table load is in
it, as in every `align` a user runs."""


def read(rec):
    reads = sum(j["reads"] for j in rec["jobs"] if not j["failed"])
    return reads / rec["window_s"] if reads and rec["window_s"] > 0 else None
