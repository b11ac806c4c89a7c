"""Mean seconds, over a run's jobs that did not fail, of the program's
`pipeline.resolve` counter (the run log's `stage_end` total of an align):
the emission thread resolving the passing rows of each chunk's wire into
feature strings, inside `pipeline.emit`. None where the program has no
such counter."""


def read(rec):
    walls = [j["stages"]["pipeline.resolve"] for j in rec["jobs"]
             if not j["failed"] and "pipeline.resolve" in j["stages"]]
    return sum(walls) / len(walls) if walls else None
