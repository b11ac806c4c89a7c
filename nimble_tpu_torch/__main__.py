"""nimble_tpu_torch CLI — the same subcommand surface as nimble_tpu's.

`align` runs the port on an explicit `--device` (cuda by default; cpu runs
the plain torch twins), resumes an interrupted run with `--resume`, and runs
as one process of a world under NIMBLE_TPU_NUM_PROCS / NIMBLE_TPU_PROC_ID.
`report` runs the exact host engine, or with `--device [cuda|cpu]` the UMI
pipeline as torch segment ops (bare `--device` is cuda, as the reference's
flag runs on its accelerator), or with `--distributed N` that pipeline on N
shards after a (cb, umi) bucket exchange (cuda:0..N-1, or N CPU shards
under `--device cpu`). `index --warm` builds and saves the index, then
builds the engine the first `align` would build on `--device` and runs one
span through it. `generate`, `fastq-to-bam`, `plot`, `index` and `download`
run the port's own copies of the reference's host modules; nothing here
imports nimble_tpu. `align --mesh` runs on a data x feature grid of devices
(parallel/mesh.py), and JAX_COORDINATOR_ADDRESS starts a coordinated world
of align processes over torch.distributed (parallel/dist.py).
"""
from __future__ import annotations

import argparse
import sys


def _ensure_native() -> None:
    """Build the native host library before its loader looks; say so on
    stderr when no compiler can."""
    from nimble_tpu_torch.native_build import build_native

    ok, how = build_native()
    if not ok:
        print(f"nimble_tpu_torch: the native host library is unavailable ({how}); host IO "
              "runs the slower python readers, the output is the same", file=sys.stderr)


def main(argv=None) -> int:
    from nimble_tpu_torch import __version__
    from nimble_tpu_torch.device import DEVICES

    parser = argparse.ArgumentParser(prog="nimble_tpu_torch", description="nimble_tpu_torch align")
    parser.add_argument("-v", "--version", action="version", version=f"nimble_tpu_torch {__version__}")
    subparsers = parser.add_subparsers(title="subcommands", dest="subcommand")

    download_parser = subparsers.add_parser("download")
    download_parser.add_argument("--release", type=str, default=[])

    generate_parser = subparsers.add_parser("generate")
    generate_parser.add_argument("--file", help="The file to process.", type=str, required=True)
    generate_parser.add_argument("--opt-file", help="The optional file to process.", type=str, default=None)
    generate_parser.add_argument("--output_path", help="The path to the output file.", type=str, required=True)

    align_parser = subparsers.add_parser("align")
    align_parser.add_argument("--reference", help="Comma-separated library JSON list.", type=str, required=True)
    align_parser.add_argument("--output", help="The path to the output file.", type=str, required=True)
    align_parser.add_argument("--input", help="The input reads (1-2 FASTQs or 1 BAM).", type=str, required=True, nargs="+")
    align_parser.add_argument("-c", "--num_cores", help="Cores for host-side IO.", type=int, default=1)
    align_parser.add_argument("--strand_filter", type=str, default="unstranded")
    align_parser.add_argument("--trim", help="Trim config <TARGET_LENGTH>:<STRICTNESS>, comma-separated per library.", type=str, default="")
    align_parser.add_argument("--tmpdir", help="Accepted for compatibility (no BAM sort needed).", type=str, default=None)
    align_parser.add_argument(
        "--max-read-length", type=int, default=0,
        help="Packed read width (0 = auto from the first batch, capped at "
             "256; explicit values also truncate longer reads).",
    )
    align_parser.add_argument(
        "--chunk-size", type=int, default=0,
        help="Reads per device step (0 = auto-size from the device "
             "transient budget; see align.engine.auto_chunk_size).",
    )
    align_parser.add_argument(
        "--resume", action="store_true", default=False,
        help="Continue an interrupted run from its <output>.progress.json "
             "sidecar (in a world, each process from its own shard's).",
    )
    align_parser.add_argument(
        "--mesh", type=str, default="",
        help="Device mesh spec: 'data=N[,feature=M]', a bare N, 'feature=M' "
             "or 'auto'. On cuda the grid takes the visible cards "
             "(cuda:0..n-1; 'auto' and a data axis left out fill them) and a "
             "grid larger than they are exits 1. On cpu an explicit data=N "
             "takes exactly N*M CPU shards, and 'auto' or a data axis left "
             "out takes one data shard.",
    )
    align_parser.add_argument(
        "--probe", type=str, default="group", choices=("group", "mono"),
        help="k-mer probe path: 'group' (default) probes one (k+g-1)-mer per "
             "g windows; 'mono' probes every k-window (the per-k-mer contract).",
    )
    align_parser.add_argument(
        "--device", type=str, default="cuda", choices=DEVICES,
        help="Device of the align step: 'cuda' (default; raises when no card "
             "is visible) or 'cpu' (the plain torch twins).",
    )

    report_parser = subparsers.add_parser("report")
    report_parser.add_argument("-i", "--input", type=str, required=True)
    report_parser.add_argument("-o", "--output", type=str, required=True)
    report_parser.add_argument("-s", "--summarize", help="CSV list of columns to summarize.", type=str, default=None)
    report_parser.add_argument("-t", "--threshold", type=float, default=0.05)
    report_parser.add_argument("--disable_thresholding", action="store_true", default=False)
    report_parser.add_argument(
        "--device", nargs="?", const="cuda", default=None, choices=DEVICES,
        help="Run the UMI pipeline as torch segment ops (quant/device.py) "
             "instead of the exact host path: on the card ('cuda', also the "
             "bare flag; raises when no card is visible) or 'cpu'.",
    )
    report_parser.add_argument(
        "--distributed", type=int, default=0, metavar="N",
        help="Shard the device UMI pipeline over N shards after a cell-barcode "
             "and UMI bucket exchange (parallel/dist.py): cuda:0..N-1 (the "
             "default), or N CPU shards with --device cpu.",
    )
    report_parser.add_argument(
        "--stream", action="store_true", default=None,
        help="Run the exact host pipeline via bounded spill buckets "
             "(quant/stream.py). Default: auto above "
             "NIMBLE_TPU_REPORT_STREAM_MB (4096); host engine only.",
    )

    plot_parser = subparsers.add_parser("plot")
    plot_parser.add_argument("--input_file", type=str, required=True)
    plot_parser.add_argument("--output_file", type=str, required=True)

    f2b_parser = subparsers.add_parser("fastq-to-bam")
    f2b_parser.add_argument("--r1-fastq", type=str, required=True)
    f2b_parser.add_argument("--r2-fastq", type=str, required=True)
    f2b_parser.add_argument("--map", required=True, help="Cell barcode whitelist (one CB per line, .gz or plain)")
    f2b_parser.add_argument("--output", type=str, required=True)
    f2b_parser.add_argument("-c", "--num_cores", type=int, default=1)
    f2b_parser.add_argument("--cb-length", type=int, default=16)
    f2b_parser.add_argument("--umi-length", type=int, default=12)

    index_parser = subparsers.add_parser("index", help="Prebuild and persist the k-mer index (.npz)")
    index_parser.add_argument("--reference", type=str, required=True)
    index_parser.add_argument(
        "--output", type=str, default=None,
        help="Output .npz (default: the <reference>.idx.npz sidecar that `align` auto-loads)",
    )
    index_parser.add_argument("--kmer-length", type=int, default=None)
    index_parser.add_argument("--probe", type=str, default="group", choices=("group", "mono"))
    index_parser.add_argument(
        "--warm", type=int, default=0, metavar="READ_LEN", nargs="?", const=100,
        help="After saving the index, build the engine the first `align` of "
             "reads this long (default 100 when given bare) would build on "
             "--device, with its sidecar and the kernel library, and run one "
             "span through it. Pays off only with the default --output, the "
             "index that `align` auto-loads.",
    )
    index_parser.add_argument("--paired", action="store_true", default=False,
                              help="With --warm: the paired-end (R1+R2 / BAM) engine.")
    index_parser.add_argument("--chunk-size", type=int, default=0,
                              help="With --warm: the chunk size `align --chunk-size` would get (0 = auto).")
    index_parser.add_argument("--strand_filter", type=str, default="unstranded",
                              help="With --warm: the strand filter of the later `align`.")
    index_parser.add_argument(
        "--device", type=str, default="cuda", choices=DEVICES,
        help="With --warm: the device of the engine, as `align --device` "
             "(cuda by default; raises when no card is visible).",
    )

    args = parser.parse_args(argv)

    if args.subcommand in ("align", "index", "fastq-to-bam", "report"):
        _ensure_native()
    if args.subcommand == "download":
        print("nimble_tpu_torch's aligner is built in; nothing to download.")
        return 0
    if args.subcommand == "generate":
        from nimble_tpu_torch.library import generate

        generate(args.file, args.opt_file, args.output_path)
        return 0
    if args.subcommand == "align":
        from nimble_tpu_torch.align.pipeline import align_files
        from nimble_tpu_torch.device import resolve_device

        return align_files(
            args.reference,
            args.output,
            args.input,
            resolve_device(args.device),
            strand_filter=args.strand_filter,
            chunk_size=args.chunk_size or None,
            max_len=args.max_read_length,
            resume=args.resume,
            trim=args.trim,
            num_cores=args.num_cores,
            probe=args.probe,
            mesh=args.mesh,
        )
    if args.subcommand == "report":
        from nimble_tpu_torch.report.tsv import report

        summarize_columns_list = args.summarize.split(",") if args.summarize else None
        engine = "host"
        if args.distributed > 0:
            engine = "distributed"
        elif args.device is not None:
            engine = "device"
        report(
            args.input,
            args.output,
            summarize_columns_list,
            args.threshold,
            args.disable_thresholding,
            engine=engine,
            dist_shards=args.distributed,
            stream=args.stream,
            device=args.device or "cuda",
        )
        return 0
    if args.subcommand == "plot":
        from nimble_tpu_torch.report.plots import plot_command

        plot_command(args.input_file, args.output_file)
        return 0
    if args.subcommand == "fastq-to-bam":
        from nimble_tpu_torch.barcode import fastq_to_bam_with_barcodes

        fastq_to_bam_with_barcodes(
            args.r1_fastq,
            args.r2_fastq,
            args.map,
            args.output,
            args.num_cores,
            args.cb_length,
            args.umi_length,
        )
        return 0
    if args.subcommand == "index":
        from nimble_tpu_torch.config import load_library
        from nimble_tpu_torch.device import resolve_device
        from nimble_tpu_torch.index.builder import build_index, index_cache_key, index_cache_path

        device = resolve_device(args.device) if args.warm else None  # no card, no work
        config, data = load_library(args.reference)
        group_g = 0 if args.probe == "mono" else None
        idx = build_index(data, config, k=args.kmer_length, group_g=group_g)
        out = args.output or index_cache_path(args.reference)
        # stamp the content-hash key so `align` trusts and reuses the file
        idx.save(out, cache_key=index_cache_key(args.reference, args.kmer_length, group_g))
        print(
            f"Indexed {idx.n_kmers} k-mers, {idx.n_features} features, "
            f"{idx.n_classes} classes -> {out}"
        )
        if args.warm:
            from nimble_tpu_torch.align.pipeline import warm_engine

            for line in warm_engine(idx, config, device, args.warm, strand_filter=args.strand_filter,
                                    chunk_size=args.chunk_size or None, paired=args.paired):
                print(line)
        return 0

    parser.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
