"""Mean seconds, over a run's jobs that did not fail, of the program's
`pipeline.emit` counter (the run log's `stage_end` total of an align):
the emission thread writing a span's rows and its checkpoint."""


def read(rec):
    walls = [j["stages"]["pipeline.emit"] for j in rec["jobs"] if not j["failed"] and "pipeline.emit" in j["stages"]]
    return sum(walls) / len(walls) if walls else None
