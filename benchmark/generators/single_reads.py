"""Single-end reads of one sample: {"r1"} (gen.sample_single)."""
from benchmark import gen


def make(rng, lib, n, t):
    return gen.sample_single(rng, lib, n, t)
