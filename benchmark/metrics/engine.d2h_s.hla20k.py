"""Mean seconds, over a run's jobs that did not fail, of the program's
`engine.d2h` counter (the run log's `stage_end` total of an align): the
emission thread copying the chunks' outputs to the host, (B, W + 3)
words a chunk on the full wire, with the wait for the card before it."""


def read(rec):
    walls = [j["stages"]["engine.d2h"] for j in rec["jobs"] if not j["failed"] and "engine.d2h" in j["stages"]]
    return sum(walls) / len(walls) if walls else None
