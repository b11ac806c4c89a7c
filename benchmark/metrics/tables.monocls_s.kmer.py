"""Mean seconds, over a run's jobs that did not fail, of the run log's
`tables.monocls` stage (inside `tables.host`): the numpy build of the
monocls table, the single-hash placement of every occupied k-mer entry
and the fill of its 64-byte rows. None where the program has no such
stage."""


def read(rec):
    walls = [j["stages"]["tables.monocls"] for j in rec["jobs"]
             if not j["failed"] and "tables.monocls" in j["stages"]]
    return sum(walls) / len(walls) if walls else None
