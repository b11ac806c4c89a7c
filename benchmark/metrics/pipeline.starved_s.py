"""Mean seconds, over a run's jobs that did not fail, of the program's
`pipeline.starved` counter (the run log's `stage_end` total of an
align): the dispatch thread waiting for a packed span."""


def read(rec):
    walls = [j["stages"]["pipeline.starved"] for j in rec["jobs"] if not j["failed"] and "pipeline.starved" in j["stages"]]
    return sum(walls) / len(walls) if walls else None
