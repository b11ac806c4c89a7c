"""Mean seconds, over a run's jobs that did not fail, of the run log's
`index_build` stage: the index load of the library (the 20k library's
index is ~118 MB on disk)."""


def read(rec):
    walls = [j["stages"]["index_build"] for j in rec["jobs"] if not j["failed"] and "index_build" in j["stages"]]
    return sum(walls) / len(walls) if walls else None
