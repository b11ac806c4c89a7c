"""nimble_tpu_torch — the PyTorch + CUDA port of nimble_tpu's aligner.

The JAX package `nimble_tpu/` is the reference: every module here is held
against its counterpart there, bit for bit, by tests/test_torch_*.py. This
package imports `torch` and never `jax`, and imports nothing of
`nimble_tpu`, not even its jax-free host modules: it keeps its own copies
of them under the reference's module paths (`config`, `seq`, `library`,
`remote`, `barcode`, `legacy`, `observability` without the jax profiler,
`io/*`, `index/builder`, `index/native`, the numpy half of
`index/hashing`, `quant/exact`, `quant/stream`, `report/tsv` without the
device engines, `report/plots` and its templates), and of the host code
behind `nimble_tpu/align/__init__.py` (`align/host_probe`, the pipeline
helpers, the numpy table builders). Index files and gband sidecars written
by either package load in the other.

Ported slice: `align`, single-end and paired, FASTQ and tagged BAM, on
narrow libraries (W <= 16 bitset words, up to 512 features) on the default
group probe (g = 6, W <= 8) and on the mono probe (`--probe mono`,
`num_mismatches` 1-2, `kmer_stride > 1`, 8 < W <= 16, reads shorter than
k+g-1), with the two-choice inline probe as the mono path's fallback; and
on wide libraries (W > 16) that can be banded, on the banded group path
(gband, in each of the reference's four table layouts), and the other
wide paths (groupcls, monocls, the wide two-choice
probe); several libraries at once through the stacked engine (one merged
probe answers every library); on a data x feature mesh of devices
(`--mesh`) and in worlds of processes, coordinated or not. Four
hand-written CUDA kernels run on the card — the window stage
(csrc/kmer_keys.cu), the fused mono probe (csrc/mono_probe.cu), the gband
band-row intersection (csrc/band_tree_expand.cu) and the class-bits
intersection of the class-id paths (csrc/intersect_class_bits.cu) — and
their plain torch versions on the CPU.

Modules (named after their reference counterparts):
  nimble_tpu_torch.device          — explicit device resolution
  nimble_tpu_torch.native_build    — builds the repo's native host library
  nimble_tpu_torch.bench_data      — the HLA-100 and 20k-allele bench
                                     workloads, from seeds
  nimble_tpu_torch.kernel_bench    — the kernels' device time and bounds
                                     on the main paths' own inputs, and
                                     one checkout against another
  nimble_tpu_torch.index.hashing   — bucket hashes, numpy and int64 tensors
  nimble_tpu_torch.align.tables    — group, gband, mono and two-choice
                                     device tables
  nimble_tpu_torch.align.kernels   — kmer_keys, mono_probe,
                                     band_tree_expand,
                                     intersect_class_bits: CUDA kernels +
                                     plain torch versions
  nimble_tpu_torch.align.engine    — the align steps, output wires, engine
  nimble_tpu_torch.align.stacked   — the stacked multi-library engine
  nimble_tpu_torch.align.host_probe— host mono repair for short reads
  nimble_tpu_torch.align.pipeline  — the `align` orchestration
  nimble_tpu_torch.parallel.mesh   — `--mesh`: the device grid, table
                                     placement
  nimble_tpu_torch.parallel.dist   — `report --distributed`, the
                                     coordinated world's process group
"""

__version__ = "0.1.0"
