"""Mean seconds a job spends in the run log's `index_build` stage: the
index load (or build) of its library."""


def read(rec):
    walls = [j["stages"]["index_build"] for j in rec["jobs"] if "index_build" in j["stages"]]
    return sum(walls) / len(walls) if walls else None
