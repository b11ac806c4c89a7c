"""ctypes binding for the native C++ k-mer index builder.

`build_index_native(data, config, k)` produces the same table layout as the
numpy builder in index/builder.py — identical bucket hash (mix32), identical
sizing policy, identical canonical/strand semantics — in seconds instead of
minutes for large allele libraries. Class NUMBERING may differ from the
numpy build (the native builder interns feature sets with exact comparison,
the numpy one with fingerprints); every probe decodes to the same feature
set, which tests/test_index.py verifies differentially.

The reference builds its index at aligner startup in Rust
(rust-pseudoaligner lineage; SURVEY §2.8) — this is the TPU build's native
equivalent, emitting device-ready tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from nimble_tpu_torch.config import Config, Data
from nimble_tpu_torch.io import native as native_io


def _lib() -> Optional[ctypes.CDLL]:
    lib = native_io._load()
    if lib is None:
        return None
    if not hasattr(lib, "_index_bound"):
        try:
            lib.nt_index_build.restype = ctypes.c_void_p
            lib.nt_index_build.argtypes = [
                ctypes.c_void_p,  # seqs
                ctypes.c_void_p,  # offs
                ctypes.c_void_p,  # seq_lens
                ctypes.c_void_p,  # feature_ids
                ctypes.c_int64,  # n_seqs
                ctypes.c_int32,  # k
                ctypes.c_int32,  # hamming1
                ctypes.c_int32,  # n_features
            ]
            lib.nt_index_sizes.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.nt_index_export.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 11
            lib.nt_index_free.argtypes = [ctypes.c_void_p]
        except AttributeError:
            return None  # stale .so without the index symbols
        lib._index_bound = True
    return lib


def available() -> bool:
    return _lib() is not None


def build_index_native(
    data: Data, config: Optional[Config] = None, k: Optional[int] = None
):
    """Native-accelerated build_index. Raises RuntimeError if the native
    library is unavailable (callers fall back to the numpy builder)."""
    from nimble_tpu_torch.index.builder import STASH_SIZE, BUCKET_SLOTS, KmerIndex
    from nimble_tpu_torch.index import builder as pybuilder

    lib = _lib()
    if lib is None:
        raise RuntimeError("native index builder unavailable")
    config = config or Config()
    k = int(k or config.kmer_length)
    if not (1 <= k <= 31):
        raise ValueError(f"kmer_length must be in [1, 31], got {k}")

    # feature ids in first-occurrence order (same as the numpy builder)
    names = data.sequence_names
    feature_names = []
    name_to_fid = {}
    feature_ids = np.empty(len(names), dtype=np.int32)
    for i, name in enumerate(names):
        fid = name_to_fid.get(name)
        if fid is None:
            fid = len(feature_names)
            name_to_fid[name] = fid
            feature_names.append(name)
        feature_ids[i] = fid
    n_features = len(feature_names)

    # pack sequences into one ASCII buffer
    seq_bytes = [
        s.encode("ascii", errors="replace") if isinstance(s, str) else bytes(s)
        for s in data.sequences
    ]
    seq_lens = np.array([len(s) for s in seq_bytes], dtype=np.int64)
    offs = np.zeros(len(seq_bytes) + 1, dtype=np.int64)
    np.cumsum(seq_lens, out=offs[1:])
    buf = np.frombuffer(b"".join(seq_bytes), dtype=np.uint8).copy() if seq_bytes else np.zeros(1, np.uint8)
    if buf.size == 0:
        buf = np.zeros(1, dtype=np.uint8)

    handle = lib.nt_index_build(
        buf.ctypes.data_as(ctypes.c_void_p),
        offs.ctypes.data_as(ctypes.c_void_p),
        seq_lens.ctypes.data_as(ctypes.c_void_p),
        feature_ids.ctypes.data_as(ctypes.c_void_p),
        len(seq_bytes),
        k,
        1 if config.num_mismatches > 0 else 0,
        n_features,
    )
    if not handle:
        raise RuntimeError("nt_index_build failed")
    try:
        sizes = np.zeros(6, dtype=np.int64)
        lib.nt_index_sizes(handle, sizes.ctypes.data_as(ctypes.c_void_p))
        n_buckets, n_kmers, n_classes, cf_len, _stash_used, bits_words = (
            int(v) for v in sizes
        )

        n_slots = n_buckets * BUCKET_SLOTS
        table_hi = np.empty(n_slots, dtype=np.uint32)
        table_lo = np.empty(n_slots, dtype=np.uint32)
        table_vsame = np.empty(n_slots, dtype=np.int32)
        table_vdiff = np.empty(n_slots, dtype=np.int32)
        stash_hi = np.empty(STASH_SIZE, dtype=np.uint32)
        stash_lo = np.empty(STASH_SIZE, dtype=np.uint32)
        stash_vsame = np.empty(STASH_SIZE, dtype=np.int32)
        stash_vdiff = np.empty(STASH_SIZE, dtype=np.int32)
        class_offsets = np.empty(n_classes + 1, dtype=np.int64)
        class_features = np.empty(max(cf_len, 1), dtype=np.int32)
        class_bits = np.empty((max(n_classes, 1), bits_words), dtype=np.uint32)
        lib.nt_index_export(
            handle,
            *(
                a.ctypes.data_as(ctypes.c_void_p)
                for a in (
                    table_hi,
                    table_lo,
                    table_vsame,
                    table_vdiff,
                    stash_hi,
                    stash_lo,
                    stash_vsame,
                    stash_vdiff,
                    class_offsets,
                    class_features,
                    class_bits,
                )
            ),
        )
        class_features = class_features[:cf_len]
        class_bits = class_bits[:n_classes]
    finally:
        lib.nt_index_free(handle)

    group_names, feature_to_group = pybuilder._group_mapping(
        config, data, names, feature_ids, feature_names
    )
    return KmerIndex(
        k=k,
        n_buckets=n_buckets,
        table_hi=table_hi,
        table_lo=table_lo,
        table_vsame=table_vsame,
        table_vdiff=table_vdiff,
        stash_hi=stash_hi,
        stash_lo=stash_lo,
        stash_vsame=stash_vsame,
        stash_vdiff=stash_vdiff,
        class_offsets=class_offsets,
        class_features=class_features,
        class_bits=class_bits,
        feature_names=feature_names,
        group_names=group_names,
        feature_to_group=feature_to_group,
        group_bits_words=max(1, -(-len(group_names) // 32)),
        n_kmers=n_kmers,
    )
