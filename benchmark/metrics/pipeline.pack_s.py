"""Mean seconds, over a run's jobs that did not fail, of the program's
`pipeline.pack` counter (the run log's `stage_end` total of an align):
the feeder thread's 2-bit pack and span cut."""


def read(rec):
    walls = [j["stages"]["pipeline.pack"] for j in rec["jobs"] if not j["failed"] and "pipeline.pack" in j["stages"]]
    return sum(walls) / len(walls) if walls else None
