"""Single-end reads as one gz FASTQ, `<stem>.fastq.gz`."""
from benchmark import gen


def write(stem, reads) -> list:
    path = stem.with_name(stem.name + ".fastq.gz")
    gen.write_fastq_gz(path, reads["r1"])
    return [str(path)]
