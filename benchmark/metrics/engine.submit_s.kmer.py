"""Mean seconds, over a run's jobs that did not fail, of the program's
`engine.submit` counter (the run log's `stage_end` total of an align):
the dispatch thread launching a span's chunks (their torch ops and
pageable copies to the card), on the 20k library's monocls path."""


def read(rec):
    walls = [j["stages"]["engine.submit"] for j in rec["jobs"] if not j["failed"] and "engine.submit" in j["stages"]]
    return sum(walls) / len(walls) if walls else None
