"""Mean seconds, over a run's jobs that did not fail, of the program's
`pipeline.read` counter (the run log's `stage_end` total of an align):
the reader thread's busy time: the BAM reader's batches."""


def read(rec):
    walls = [j["stages"]["pipeline.read"] for j in rec["jobs"] if not j["failed"] and "pipeline.read" in j["stages"]]
    return sum(walls) / len(walls) if walls else None
