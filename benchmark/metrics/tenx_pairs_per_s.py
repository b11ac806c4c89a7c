"""10x pairs taken from the tagged BAM to per-cell counts (`align`, then
`report` of its TSV) over the window's wall."""


def read(rec):
    pairs = sum(j["reads"] for j in rec["jobs"] if not j["failed"] and "report_s" in j)
    return pairs / rec["window_s"] if pairs and rec["window_s"] > 0 else None
