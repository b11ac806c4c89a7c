"""Library schema: Config (aligner scoring criteria) and Data (sequence table).

The on-disk library format is a 2-element JSON array ``[Config, Data]``,
byte-compatible with the reference format (reference: nimble/types.py:10-32,
nimble/__main__.py:64-65). ``Config`` is the semantic contract the alignment
engine honors; ``Data`` is a columnar table of sequences plus arbitrary
metadata columns (which is how ``group_on`` targets enter the library).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple


# The reference serializes DataType.FASTA (a str-Enum) as the string "RNA"
# (reference: nimble/types.py:5-6).
DATA_TYPE_RNA = "RNA"

BASE_HEADERS = ["reference_genome", "sequence_name", "nt_length", "sequence"]


@dataclass
class Config:
    """Aligner scoring configuration (reference: nimble/types.py:10-25).

    Field semantics (the reference backend is a pseudoaligner; semantics
    reconstructed from its frontend contract):
      score_threshold: minimum alignment score, in matched bases, for a
        read(-mate) to be considered a hit at all.
      score_filter: minimum total score for a read-pair row to be reported.
      score_percent: minimum score as a fraction of (non-barcode) read length.
      num_mismatches: number of mismatches tolerated during k-mer matching
        (implemented via Hamming-neighborhood index expansion).
      discard_multiple_matches: drop reads whose hit set has >1 feature.
      intersect_level: how r1/r2 hit sets combine (kallisto-style mate
        intersection): 0 = intersect, empty -> unmapped; 1 = intersect with
        fallback to the union when empty; 2 = force concordance (both mates
        must hit and intersect).
      group_on: metadata column name to collapse hits onto (e.g. allele ->
        lineage); empty string = report sequence_name-level hits.
      discard_multi_hits: if > 0, drop reads whose hit set exceeds this size.
      require_valid_pair: require both mates to align to the same feature set.
      data_type: library data type tag ("RNA").
      filters: legacy bulk-report filter chain ([{"name": ..., "value": ...}]).
      max_hits_to_report: cap on the reported ambiguity-class size.
      trim_target_length / trim_strictness: read-trimming configuration.
    """

    score_threshold: int = 20
    score_filter: int = 25
    score_percent: float = 0.5
    num_mismatches: int = 0
    discard_multiple_matches: bool = False
    intersect_level: int = 0
    group_on: str = ""
    discard_multi_hits: int = 0
    require_valid_pair: bool = False
    data_type: str = DATA_TYPE_RNA
    filters: List[Dict[str, Any]] = field(default_factory=list)
    max_hits_to_report: int = 10
    trim_target_length: int = 50
    trim_strictness: float = 0.9

    # --- extension fields (nimble_tpu only; not serialized unless set) ---
    # kmer_length: k used by the index builder. The reference's backend k is
    # not part of the library schema; we default to 21 and allow override.
    kmer_length: int = 21
    # kmer_stride: probe every stride-th read window (1 = every position,
    # the reference-equivalent default). Stride > 1 trades a small amount of
    # score resolution / error tolerance for proportionally less probe work.
    kmer_stride: int = 1

    _EXTENSION_FIELDS = ("kmer_length", "kmer_stride")

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        # Keep the serialized form identical to the reference schema: only
        # emit extension fields when they differ from defaults.
        for name in self._EXTENSION_FIELDS:
            if d[name] == getattr(type(self), "__dataclass_fields__")[name].default:
                del d[name]
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        cfg = cls()
        for key, value in d.items():
            if hasattr(cfg, key):
                setattr(cfg, key, value)
        return cfg

    def trim_spec(self) -> Tuple[int, float] | None:
        """The library's read-trim configuration, or None when untouched.

        Every library JSON carries trim_target_length/trim_strictness (the
        reference schema serializes all Config fields), so "the user asked
        for trimming" is detected as EITHER field differing from the schema
        defaults (50, 0.9) — the reference workflow is hand-editing the
        generated JSON (reference: __main__.py:44). A library left at the
        defaults aligns untrimmed, matching the reference frontend, which
        only forwards trim settings via the --trim flag
        (reference: __main__.py:191-192)."""
        fields = type(self).__dataclass_fields__
        if (
            self.trim_target_length == fields["trim_target_length"].default
            and self.trim_strictness == fields["trim_strictness"].default
        ):
            return None
        return int(self.trim_target_length), float(self.trim_strictness)


@dataclass
class Data:
    """Columnar sequence + metadata table (reference: nimble/types.py:29-32).

    headers: column names; the first four are always BASE_HEADERS, any
    remaining columns are caller-provided metadata (group_on targets).
    columns: list of string-lists, one per header, all the same length.
    """

    headers: List[str] = field(default_factory=lambda: list(BASE_HEADERS))
    columns: List[List[str]] = field(default_factory=lambda: [[], [], [], []])

    def to_dict(self) -> Dict[str, Any]:
        return {"headers": self.headers, "columns": self.columns}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Data":
        return cls(headers=list(d["headers"]), columns=[list(c) for c in d["columns"]])

    def __len__(self) -> int:
        return len(self.columns[0]) if self.columns else 0

    def column(self, name: str) -> List[str]:
        return self.columns[self.headers.index(name)]

    @property
    def sequence_names(self) -> List[str]:
        return self.column("sequence_name")

    @property
    def sequences(self) -> List[str]:
        return self.column("sequence")


def save_library(path: str, config: Config, data: Data) -> None:
    """Write the [Config, Data] JSON library (reference: __main__.py:64-65)."""
    with open(path, "w") as f:
        json.dump([config.to_dict(), data.to_dict()], f, indent=2)


def load_library(path: str) -> Tuple[Config, Data]:
    with open(path) as f:
        raw = json.load(f)
    if not (isinstance(raw, list) and len(raw) == 2):
        raise ValueError(f"{path}: expected a 2-element [Config, Data] JSON array")
    return Config.from_dict(raw[0]), Data.from_dict(raw[1])
