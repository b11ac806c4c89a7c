"""Mean seconds, over a run's jobs that did not fail, of the run log's
`tables.host` stage (inside `engine_build`): the numpy build of the
path's tables (on groupcls the ~4 GB class-id bucket), or the gband
sidecar's load."""


def read(rec):
    walls = [j["stages"]["tables.host"] for j in rec["jobs"] if not j["failed"] and "tables.host" in j["stages"]]
    return sum(walls) / len(walls) if walls else None
