from nimble_tpu_torch.io.fasta import read_fasta, write_fasta
from nimble_tpu_torch.io.fastq import FastqReader, read_fastq, write_fastq

__all__ = ["read_fasta", "write_fasta", "FastqReader", "read_fastq", "write_fastq"]
