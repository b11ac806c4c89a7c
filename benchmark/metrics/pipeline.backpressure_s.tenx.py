"""Mean seconds, over a run's jobs that did not fail, of the program's
`pipeline.backpressure` counter (the run log's `stage_end` total of an
align): the dispatch thread waiting for the emission thread (a full
emission queue, the final drain)."""


def read(rec):
    walls = [j["stages"]["pipeline.backpressure"] for j in rec["jobs"] if not j["failed"] and "pipeline.backpressure" in j["stages"]]
    return sum(walls) / len(walls) if walls else None
