"""Mean seconds, over a run's jobs that did not fail, of the run log's
`index_build` stage: the load of the per-k-mer index of the 20k library
(`index --probe mono`: no group entries)."""


def read(rec):
    walls = [j["stages"]["index_build"] for j in rec["jobs"] if not j["failed"] and "index_build" in j["stages"]]
    return sum(walls) / len(walls) if walls else None
