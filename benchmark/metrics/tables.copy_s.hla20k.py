"""Mean seconds, over a run's jobs that did not fail, of the run log's
`tables.copy` stage (inside `engine_build`): the copy of the path's
tables (on groupcls the class-id bucket and `class_bits`) to the card."""


def read(rec):
    walls = [j["stages"]["tables.copy"] for j in rec["jobs"] if not j["failed"] and "tables.copy" in j["stages"]]
    return sum(walls) / len(walls) if walls else None
