"""Mean seconds, over a run's jobs that did not fail, of the run log's
`tables.host` stage (inside `engine_build`): on monocls the strict class
bands' refusal, the monocls table's numpy build and the view of
`class_bits`."""


def read(rec):
    walls = [j["stages"]["tables.host"] for j in rec["jobs"] if not j["failed"] and "tables.host" in j["stages"]]
    return sum(walls) / len(walls) if walls else None
