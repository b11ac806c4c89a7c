"""The comparison that decides `correct`: each job's outputs against what
the plain reference (`benchmark/reference/`) works out for the same
library and reads. Every comparison is exact: its limit is 0."""
from __future__ import annotations

TSV_HEADER = ("nimble_features\tnimble_score\tr1_CB\tr1_UB\tr2_CB\tr2_UB\tr1_POS\tr2_POS\t"
              "r1_forward_score\tr2_forward_score\tr1_GN\n")


def lines_differing(expected: str, got: str) -> int:
    """Lines of `got` that differ from `expected` at the same place, plus
    the lines one has beyond the other."""
    if expected == got:
        return 0
    a, b = expected.splitlines(), got.splitlines()
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))


def read_text(path) -> str:
    try:
        with open(path) as f:
            return f.read()
    except FileNotFoundError:
        return ""
