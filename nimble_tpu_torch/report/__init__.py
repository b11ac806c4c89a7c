from nimble_tpu_torch.report.tsv import report, write_alignment_tsv, read_alignment_tsv

__all__ = ["report", "write_alignment_tsv", "read_alignment_tsv"]
