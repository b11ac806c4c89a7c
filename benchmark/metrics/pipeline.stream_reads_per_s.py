"""Reads over the jobs' `align` walls less their `index_build` and
`engine_build` stages: the rate of the streaming part of align."""


def read(rec):
    jobs = [j for j in rec["jobs"] if not j["failed"]]
    stream = sum(j["align_s"] - j["stages"].get("index_build", 0.0) - j["stages"].get("engine_build", 0.0)
                 for j in jobs)
    reads = sum(j["reads"] for j in jobs)
    return reads / stream if reads and stream > 0 else None
