"""nimble_tpu_torch — the PyTorch + CUDA port of nimble_tpu's aligner.

The JAX package `nimble_tpu/` is the reference: every module here is held
against its counterpart there, bit for bit, by tests/test_torch_*.py. This
package imports `torch` and never `jax`. Host code that imports no jax
(`config`, `library`, `seq`, `io/*`, `index/builder.py`, `barcode`,
`quant/exact`, `quant/stream`, `report/*`, `legacy`) is shared by import;
host code that lives behind `nimble_tpu/align/__init__.py` (which imports
the JAX engine) is copied here.

Ported slice: `align` on the default group probe (g = 6) against narrow
libraries (W <= 8 bitset words), single-end and paired, FASTQ and tagged
BAM. The window stage runs as a hand-written CUDA kernel
(csrc/kmer_keys.cu) on the card and as its plain torch twin on the CPU.

Modules (named after their reference counterparts):
  nimble_tpu_torch.device          — explicit device resolution
  nimble_tpu_torch.index.hashing   — bucket hashes on int64 tensors
  nimble_tpu_torch.align.tables    — group-probe device tables
  nimble_tpu_torch.align.kernels   — kmer_keys: CUDA kernel + torch twin
  nimble_tpu_torch.align.engine    — the group-path align step and engine
  nimble_tpu_torch.align.host_probe— host mono repair for short reads
  nimble_tpu_torch.align.pipeline  — the `align` orchestration
"""

__version__ = "0.1.0"
