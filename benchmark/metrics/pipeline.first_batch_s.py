"""Mean seconds, over a run's jobs that did not fail, of the program's
`pipeline.first_batch` counter (the run log's `stage_end` total of an
align): the serial read of the first reader batch, before the engines
are built."""


def read(rec):
    walls = [j["stages"]["pipeline.first_batch"] for j in rec["jobs"] if not j["failed"] and "pipeline.first_batch" in j["stages"]]
    return sum(walls) / len(walls) if walls else None
