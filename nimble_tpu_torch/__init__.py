"""nimble_tpu_torch — the PyTorch + CUDA port of nimble_tpu's aligner.

The JAX package `nimble_tpu/` is the reference: every module here is held
against its counterpart there, bit for bit, by tests/test_torch_*.py. This
package imports `torch` and never `jax`. Host code that imports no jax
(`config`, `library`, `seq`, `io/*`, `index/builder.py`, `barcode`,
`quant/exact`, `quant/stream`, `report/*`, `legacy`) is shared by import;
host code that lives behind `nimble_tpu/align/__init__.py` (which imports
the JAX engine) is copied here.

Ported slice: `align`, single-end and paired, FASTQ and tagged BAM, on
narrow libraries (W <= 16 bitset words, up to 512 features) on the default
group probe (g = 6, W <= 8) and on the mono probe (`--probe mono`,
`num_mismatches` 1-2, `kmer_stride > 1`, 8 < W <= 16, reads shorter than
k+g-1), with the two-choice inline probe as the mono path's fallback; and
on wide libraries (W > 16) that can be banded, on the banded group path
(gband). Three hand-written CUDA kernels run on the card — the window stage
(csrc/kmer_keys.cu), the fused mono probe (csrc/mono_probe.cu) and the
gband band-row intersection (csrc/band_tree_expand.cu) — and their plain
torch versions on the CPU.

Modules (named after their reference counterparts):
  nimble_tpu_torch.device          — explicit device resolution
  nimble_tpu_torch.native_build    — builds the shared native host library
  nimble_tpu_torch.index.hashing   — bucket hashes on int64 tensors
  nimble_tpu_torch.align.tables    — group, gband, mono and two-choice
                                     device tables
  nimble_tpu_torch.align.kernels   — kmer_keys, mono_probe,
                                     band_tree_expand: CUDA kernels + plain
                                     torch versions
  nimble_tpu_torch.align.engine    — the align steps, output wires, engine
  nimble_tpu_torch.align.host_probe— host mono repair for short reads
  nimble_tpu_torch.align.pipeline  — the `align` orchestration
"""

__version__ = "0.1.0"
