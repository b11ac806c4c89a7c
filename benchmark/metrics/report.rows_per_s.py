"""Align TSV rows over the `report` calls' walls (parse, counts, write)."""


def read(rec):
    jobs = [j for j in rec["jobs"] if not j["failed"] and "report_s" in j]
    wall = sum(j["report_s"] for j in jobs)
    rows = sum(j["rows"] for j in jobs)
    return rows / wall if rows and wall > 0 else None
