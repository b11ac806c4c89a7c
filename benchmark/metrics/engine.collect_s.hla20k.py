"""Mean seconds, over a run's jobs that did not fail, of the program's
`engine.collect` counter (the run log's `stage_end` total of an align):
the emission thread waiting for the card, copying a span's outputs back
and unpacking them."""


def read(rec):
    walls = [j["stages"]["engine.collect"] for j in rec["jobs"] if not j["failed"] and "engine.collect" in j["stages"]]
    return sum(walls) / len(walls) if walls else None
