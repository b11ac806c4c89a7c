"""Library generation: FASTA/CSV -> [Config, Data] JSON.

Byte-compatible with the reference's `generate` subcommand (reference:
nimble/__main__.py:45-110, nimble/parse.py:15-139): a lone FASTA produces a
simple library; a lone CSV must carry a `sequence` column (literal sequence or
a genbank:// link); a CSV+FASTA pair joins FASTA sequences into CSV metadata
rows by sequence name. All CSV columns other than `name`/`sequence` are copied
verbatim as metadata columns (the `group_on` targets).
"""
from __future__ import annotations

import csv
import pathlib
import sys
from typing import List, Optional, Tuple

from nimble_tpu_torch.config import Config, Data, save_library


def get_library_name_from_filename(seq_path: str) -> str:
    """Prettified filename used as reference_genome (reference: utils.py:31-32)."""
    return pathlib.Path(seq_path).stem.replace("_", " ")


def trim_low_complexity_regions(seq: str) -> str:
    """Passthrough, matching the reference no-op (reference: utils.py:116-117)."""
    return seq


def parse_fasta(seq_path: str) -> Tuple[Data, Config]:
    """FASTA -> (Data, Config) (reference: parse.py:15-35)."""
    from nimble_tpu_torch.io.fasta import iter_fasta

    data = Data()
    config = Config()
    reference_name = get_library_name_from_filename(seq_path)
    for record_id, sequence in iter_fasta(seq_path):
        data.columns[0].append(reference_name)
        data.columns[1].append(record_id if record_id is not None else "null")
        data.columns[2].append(str(len(sequence)))
        data.columns[3].append(trim_low_complexity_regions(sequence))
    return data, config


def _resolve_sequence_cell(cell: str) -> Tuple[str, str]:
    """A CSV `sequence` cell is either a literal sequence or a
    `genbank://<term>[:<start-end>]` link resolved via NCBI Entrez
    (requires network). Returns (nt_length, sequence) as strings."""
    if "genbank://" in cell:
        from nimble_tpu_torch.remote import resolve_genbank

        nt_length, sequence = resolve_genbank(cell)
        return str(nt_length), sequence
    return str(len(cell)), cell


def parse_csv(csv_path: str, has_sequences: bool = True) -> Tuple[Data, Config]:
    """CSV -> (Data, Config) with schema-compatible output (reference
    behavior: parse.py:78-139; clean-room columnar implementation).

    Required columns: `name` (+ `sequence` when has_sequences). Every other
    column is carried through, in CSV order, as a metadata column — these
    are the `group_on` targets (allele -> lineage etc.).
    """
    with open(csv_path, newline="") as fh:
        table = list(csv.reader(fh, delimiter=",", quotechar='"'))
    header, body = table[0], table[1:]

    name_col = header.index("name")
    seq_col = header.index("sequence") if has_sequences else -1
    meta_cols = [i for i in range(len(header)) if i not in (name_col, seq_col)]

    lengths: List[str] = []
    sequences: List[str] = []
    if has_sequences:
        for resolved in (_resolve_sequence_cell(row[seq_col]) for row in body):
            lengths.append(resolved[0])
            sequences.append(trim_low_complexity_regions(resolved[1]))

    library_name = get_library_name_from_filename(csv_path)
    data = Data()
    data.headers.extend(header[i] for i in meta_cols)
    data.columns = [
        [library_name] * len(body),
        [row[name_col] for row in body],
        lengths,
        sequences,
    ]
    data.columns.extend([row[i] for row in body] for i in meta_cols)
    return data, Config()


def _process_file(file: Optional[str], paired_file: Optional[str]):
    """Dispatch by suffix (reference: __main__.py:70-85)."""
    data = None
    config = None
    is_csv = False
    if file:
        suffix = pathlib.Path(file).suffix
        if suffix == ".fasta":
            data, config = parse_fasta(file)
        elif suffix == ".csv" and paired_file:
            data, config = parse_csv(file, has_sequences=False)
            is_csv = True
        elif suffix == ".csv" and not paired_file:
            data, config = parse_csv(file, has_sequences=True)
            is_csv = True
    return data, config, is_csv


def _column(d: Data, header: str) -> List[str]:
    return d.columns[d.headers.index(header)]


def collate_data(sequences: Data, metadata: Data) -> Data:
    """Merge sequences parsed from a FASTA into the metadata table, joined
    on sequence_name (reference behavior: __main__.py:88-110; clean-room
    dict-join implementation). Every FASTA record must have a metadata row;
    metadata rows with no FASTA record keep an empty sequence."""
    seq_names = _column(sequences, "sequence_name")
    seqs = _column(sequences, "sequence")
    seq_lens = _column(sequences, "nt_length")

    # first metadata row wins for a duplicated name, like list.index would
    row_of: dict = {}
    for i, nm in enumerate(_column(metadata, "sequence_name")):
        row_of.setdefault(nm, i)

    merged_seq = [""] * len(seqs)
    merged_len = [""] * len(seqs)
    for src, nm in enumerate(seq_names):
        if nm not in row_of:
            print(f"generate: record {nm!r} is missing from the metadata CSV")
            sys.exit(1)
        merged_seq[row_of[nm]] = seqs[src]
        merged_len[row_of[nm]] = seq_lens[src]

    metadata.columns[metadata.headers.index("sequence")] = merged_seq
    metadata.columns[metadata.headers.index("nt_length")] = merged_len
    return metadata


def generate(file: str, opt_file: Optional[str], output_path: str) -> None:
    """Generate and write a human-editable [Config, Data] library JSON
    (reference: __main__.py:45-65)."""
    data, config, is_csv_req = _process_file(file, opt_file)
    data_opt, config_opt, is_csv_opt = _process_file(opt_file, file)

    final_config = config
    if data_opt is not None and is_csv_opt:
        final_config = config_opt

    if data_opt is not None:
        if is_csv_req:
            final_data = collate_data(data_opt, data)
        elif is_csv_opt:
            final_data = collate_data(data, data_opt)
        else:
            final_data = data
    else:
        final_data = data

    save_library(output_path, final_config, final_data)
