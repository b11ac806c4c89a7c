"""10x pairs of one sample: {"r1", "r2", "cb", "umi"} (gen.sample_tenx)."""
from benchmark import gen


def make(rng, lib, n, t):
    return gen.sample_tenx(rng, lib, n, t)
