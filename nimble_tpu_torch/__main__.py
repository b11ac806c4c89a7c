"""nimble_tpu_torch CLI — the same subcommand surface as nimble_tpu's.

`align` runs the port on an explicit `--device` (cuda by default; cpu runs
the plain torch twins). `generate`, `fastq-to-bam`, `report` (host engine),
`plot`, `index` and `download` dispatch to the shared jax-free host code.
`report --device`, `report --distributed` and `index --warm` are not ported
yet and exit non-zero naming their ROADMAP item.
"""
from __future__ import annotations

import argparse
import sys


def _unported(msg: str) -> int:
    print(f"nimble_tpu_torch: {msg}", file=sys.stderr)
    return 2


def _ensure_native() -> None:
    """Build the shared native host library before its loader looks; say
    so on stderr when no compiler can."""
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
    align_parser.add_argument("--resume", action="store_true", default=False,
                              help="Not ported (ROADMAP Queue 1 item 13).")
    align_parser.add_argument("--mesh", type=str, default="",
                              help="Not ported (ROADMAP Queue 1 item 13).")
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
    report_parser.add_argument("--device", action="store_true", default=False,
                               help="Not ported (ROADMAP Queue 1 item 12).")
    report_parser.add_argument("--distributed", type=int, default=0, metavar="N",
                               help="Not ported (ROADMAP Queue 1 items 12-13).")
    report_parser.add_argument(
        "--stream", action="store_true", default=None,
        help="Run the exact host pipeline via bounded spill buckets "
             "(quant/stream.py). Default: auto above "
             "NIMBLE_TPU_REPORT_STREAM_MB (4096).",
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
    index_parser.add_argument("--warm", type=int, default=0, metavar="READ_LEN", nargs="?", const=100,
                              help="Not ported (ROADMAP Queue 1 item 14).")
    index_parser.add_argument("--paired", action="store_true", default=False)
    index_parser.add_argument("--chunk-size", type=int, default=0)
    index_parser.add_argument("--strand_filter", type=str, default="unstranded")

    args = parser.parse_args(argv)

    if args.subcommand in ("align", "index", "fastq-to-bam", "report"):
        _ensure_native()
    if args.subcommand == "download":
        print("nimble_tpu_torch's aligner is built in; nothing to download.")
        return 0
    if args.subcommand == "generate":
        from nimble_tpu.library import generate

        generate(args.file, args.opt_file, args.output_path)
        return 0
    if args.subcommand == "align":
        from nimble_tpu_torch.align.pipeline import align_files, refuse_unported
        from nimble_tpu_torch.device import resolve_device

        try:
            refuse_unported(mesh=args.mesh, resume=args.resume)
        except NotImplementedError as e:
            return _unported(str(e))
        return align_files(
            args.reference,
            args.output,
            args.input,
            resolve_device(args.device),
            strand_filter=args.strand_filter,
            chunk_size=args.chunk_size or None,
            max_len=args.max_read_length,
            trim=args.trim,
            num_cores=args.num_cores,
            probe=args.probe,
        )
    if args.subcommand == "report":
        if args.distributed > 0:
            return _unported("report --distributed is ROADMAP Queue 1 items 12-13")
        if args.device:
            return _unported("report --device is ROADMAP Queue 1 item 12")
        from nimble_tpu.report.tsv import report

        summarize_columns_list = args.summarize.split(",") if args.summarize else None
        report(
            args.input,
            args.output,
            summarize_columns_list,
            args.threshold,
            args.disable_thresholding,
            engine="host",
            stream=args.stream,
        )
        return 0
    if args.subcommand == "plot":
        from nimble_tpu.report.plots import plot_command

        plot_command(args.input_file, args.output_file)
        return 0
    if args.subcommand == "fastq-to-bam":
        from nimble_tpu.barcode import fastq_to_bam_with_barcodes

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
        if args.warm:
            return _unported("index --warm is ROADMAP Queue 1 item 14")
        from nimble_tpu.config import load_library
        from nimble_tpu.index.builder import build_index, index_cache_key, index_cache_path

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
        return 0

    parser.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
