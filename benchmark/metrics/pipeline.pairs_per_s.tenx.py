"""10x pairs over the `align` calls' walls (the report left out)."""


def read(rec):
    jobs = [j for j in rec["jobs"] if not j["failed"]]
    wall = sum(j["align_s"] for j in jobs)
    pairs = sum(j["reads"] for j in jobs)
    return pairs / wall if pairs and wall > 0 else None
