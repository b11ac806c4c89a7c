"""10x pairs as a cellranger-style tagged BAM (CB and UB on both mates),
`<stem>.bam`."""
from benchmark.bgzf import tagged_pairs_bam


def write(stem, reads) -> list:
    path = stem.with_name(stem.name + ".bam")
    tagged_pairs_bam(path, reads["cb"], reads["umi"], reads["r1"], reads["r2"])
    return [str(path)]
