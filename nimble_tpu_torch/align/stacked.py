"""A name kept for the benchmark's kernels layer, which wraps
`nimble_tpu_torch.align.stacked.mono_probe` when a traced run installs its
spans. The port runs several libraries with one engine each
(align/pipeline.py), so nothing in the port imports this module: it only
re-exports the kernel, and goes once the benchmark drops that wrap point.
"""
from nimble_tpu_torch.align.kernels import mono_probe  # noqa: F401
