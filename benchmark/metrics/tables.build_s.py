"""Mean seconds a job spends in the run log's `engine_build` stage: table
build or sidecar load, copy to the card, re-lay."""


def read(rec):
    walls = [j["stages"]["engine_build"] for j in rec["jobs"] if "engine_build" in j["stages"]]
    return sum(walls) / len(walls) if walls else None
