"""Distributed quantification: a (cb, umi) bucket exchange, then the device
UMI pipeline on each shard and a host merge (the reference's
parallel/dist.py, behind `report --distributed N`).

  1. each data shard holds its own slice of the aligned rows;
  2. rows are routed so that each shard owns a disjoint set of (cb, umi)
     pairs: bucket = hash(cb, umi) mod n_shards. The reference exchanges
     the blocks with jax.lax.all_to_all over a mesh's "data" axis; in one
     process the exchange is a block transpose of the shards' tensors
     (source shard s's block d goes to shard d), and each destination
     shard's rows then move to its device;
  3. every shard runs the device UMI pipeline (quant/device.py) on the rows
     it owns, on its device: (cb, umi) grouping is shard-local by
     construction;
  4. the per-shard count rows are merged on the host, summing per (cb,
     feature).

Bucketing on the (cb, umi) pair rather than cb alone keeps the exchange
skew-proof: a barcode that holds half the rows still spreads over the
shards, because its UMIs hash independently.

Keys travel as 64-bit blake2b string hashes (two int32 lanes); the host
keeps hash -> string maps for decoding. If two distinct strings' hashes
collide, the whole batch is re-hashed with a salted family. This host half
decides which shard owns which group, so it is the reference's, bit for
bit.

The shards are cuda:0 .. cuda:N-1, or N CPU shards (any N >= 1, as the
reference's tests force 8 host devices).

`init_distributed()` joins the coordinated world of `align` (the
reference's jax.distributed) over torch.distributed, from the reference's
own variables, so that a launch script carries over.
"""
from __future__ import annotations

import hashlib
import os
import time
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nimble_tpu_torch.device import resolve_device


# jax.distributed.initialize's default initialization_timeout
COORDINATOR_TIMEOUT_S = 300


def init_distributed(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Join a coordinated world from the arguments or the reference's
    variables (JAX_COORDINATOR_ADDRESS host:port, JAX_NUM_PROCESSES,
    JAX_PROCESS_ID): a torch.distributed process group with the gloo
    backend, its rendezvous at tcp://<address>. Returns True when a group
    was made, False without an address.

    The backend is gloo on cpu and cuda alike. `align` exchanges no tensor
    between processes: the coordinator gives each process its rank and the
    world's size, and the shards meet through the filesystem merge (`.done`
    sentinels, pipeline._merge_shards), as in the NIMBLE_TPU_NUM_PROCS
    world. NCCL would also refuse two ranks on one GPU."""
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not coordinator_address:
        return False
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes or os.environ.get("JAX_NUM_PROCESSES", 1)),
        rank=int(process_id or os.environ.get("JAX_PROCESS_ID", 0)),
        timeout=timedelta(seconds=COORDINATOR_TIMEOUT_S),
    )
    return True


def shard_devices(n_shards: int, device="cuda") -> List[torch.device]:
    """The devices of n_shards data shards: cuda:0 .. cuda:N-1, or N CPU
    shards for 'cpu'. Raises when more CUDA shards are asked for than
    devices are visible (the reference's make_mesh asserts the same)."""
    dev = resolve_device(device) if isinstance(device, str) else torch.device(device)
    if n_shards < 1:
        raise ValueError(f"--distributed needs at least one shard, got {n_shards}")
    if dev.type == "cpu":
        return [torch.device("cpu")] * n_shards
    count = torch.cuda.device_count()
    if n_shards > count:
        raise ValueError(
            f"--distributed {n_shards} needs {n_shards} CUDA devices, and {count} "
            f"{'is' if count == 1 else 'are'} visible; pass --device cpu to run "
            f"{n_shards} CPU shards")
    return [torch.device("cuda", i) for i in range(n_shards)]


def hash64(value: str, salt: int = 0) -> Tuple[np.int32, np.int32]:
    """Stable 64-bit string hash as two int32 words. salt > 0 selects an
    independent blake2b family (collision fallback)."""
    key = b"s%d" % salt if salt else b""
    digest = hashlib.blake2b(value.encode(), digest_size=8, salt=key).digest()
    v = int.from_bytes(digest, "little")
    return np.int32((v >> 32) - (1 << 31)), np.int32((v & 0xFFFFFFFF) - (1 << 31))


def _hash_unique(strings: np.ndarray, salt: int) -> np.ndarray:
    """Hash an array of (unique) strings to (n, 2) int32 words. Python-level
    blake2b per string, but callers only pass the UNIQUE cb/umi sets — the
    per-row work stays vectorized."""
    out = np.empty((len(strings), 2), dtype=np.int32)
    key = b"s%d" % salt if salt else b""
    off = 1 << 31
    for i, s in enumerate(strings):
        digest = hashlib.blake2b(s.encode(), digest_size=8, salt=key).digest()
        v = int.from_bytes(digest, "little")
        out[i, 0] = (v >> 32) - off
        out[i, 1] = (v & 0xFFFFFFFF) - off
    return out


def _collision_free_hashes(uniq: np.ndarray, max_salts: int = 8) -> np.ndarray:
    """Hash the unique-string array, retrying with salted families until the
    64-bit keys are collision-free."""
    for salt in range(max_salts):
        h = _hash_unique(uniq, salt)
        if np.unique(h, axis=0).shape[0] == len(uniq):
            return h
    raise RuntimeError(
        f"64-bit hash collisions persisted across {max_salts} salted families"
    )


def _combined_key(words: np.ndarray) -> np.ndarray:
    """(n, 2) int32 hash words -> (n,) int64 sortable key."""
    hi = words[:, 0].astype(np.int64)
    lo = words[:, 1].astype(np.int64) & 0xFFFFFFFF
    return (hi << 32) | lo


def cb_bucket_all_to_all(devices: Sequence[torch.device], rows, valid):
    """The bucket exchange in one process. rows is (n_shards,
    rows_per_shard, width) int32 and valid (n_shards, rows_per_shard) bool,
    each source shard's rows laid out as n_shards equal blocks by
    destination bucket. The (n, n, blk, width) block array is transposed
    over its first two axes, so shard d receives block d of every source
    shard, in source order, and each shard's rows move to devices[d].
    Returns [(rows (rows_per_shard, width), valid (rows_per_shard,))] per
    shard, as tensors on their devices."""
    rows = torch.as_tensor(rows)
    valid = torch.as_tensor(valid)
    n_shards, rows_per_shard, width = rows.shape
    blk = rows_per_shard // n_shards
    r = rows.reshape(n_shards, n_shards, blk, width).transpose(0, 1).reshape(n_shards, rows_per_shard, width)
    v = valid.reshape(n_shards, n_shards, blk).transpose(0, 1).reshape(n_shards, rows_per_shard)
    return [(r[d].to(dev), v[d].to(dev)) for d, dev in enumerate(devices)]


def distributed_report(
    devices: Sequence[torch.device],
    shard_rows: Sequence[Sequence[Tuple[str, str, np.ndarray, float]]],
    feature_names: Sequence[str],
    threshold: float = 0.05,
    disable_thresholding: bool = False,
    with_dropped: bool = False,
    with_stats: bool = False,
):
    """Distributed counting over len(devices) shards in one process.

    shard_rows[s] = rows held by data shard s, each (cb, umi, bits, score)
    with bits a (W,) int32 array. Returns merged (feature, count, cb) rows
    identical to the single-host pipeline. with_stats=True appends a dict
    of exchange-buffer statistics (rows, block size, buffer rows). The
    exchange's wall, blk and buffer rows are the run log's
    `report_distributed` event."""
    from nimble_tpu_torch.observability import runlog
    from nimble_tpu_torch.quant.device import report_device

    n_shards = len(devices)
    W = len(shard_rows[0][0][2]) if shard_rows and shard_rows[0] else 1
    width = 4 + W + 1  # cb_hi, cb_lo, umi_hi, umi_lo, bits..., score(bitcast)

    # flatten every shard's rows into parallel arrays
    src_shard: List[int] = []
    cb_strs: List[str] = []
    umi_strs: List[str] = []
    bits_rows: List[np.ndarray] = []
    score_vals: List[float] = []
    for s, rows in enumerate(shard_rows):
        for cb, umi, bits, score in rows:
            src_shard.append(s)
            cb_strs.append(cb)
            umi_strs.append(umi)
            bits_rows.append(bits)
            score_vals.append(score)
    n_total = len(cb_strs)

    stats = {"rows": n_total, "blk": 0, "buffer_rows": 0}
    if n_total == 0:
        empty: List[Tuple[str, int, str]] = []
        out: Tuple = (empty,)
        if with_dropped:
            out += (0,)
        if with_stats:
            out += (stats,)
        return out if len(out) > 1 else empty

    t0 = time.perf_counter()
    uniq_cb, inv_cb = np.unique(np.asarray(cb_strs, dtype=object), return_inverse=True)
    uniq_umi, inv_umi = np.unique(np.asarray(umi_strs, dtype=object), return_inverse=True)
    cb_hash = _collision_free_hashes(uniq_cb)
    umi_hash = _collision_free_hashes(uniq_umi)

    rec = np.empty((n_total, width), dtype=np.int32)
    rec[:, 0:2] = cb_hash[inv_cb]
    rec[:, 2:4] = umi_hash[inv_umi]
    rec[:, 4 : 4 + W] = np.asarray(bits_rows, dtype=np.int32).reshape(n_total, W)
    rec[:, 4 + W] = np.asarray(score_vals, dtype=np.float32).view(np.int32)

    # skew-proof bucket: the (cb, umi) pair key (module docstring)
    pair = (
        rec[:, 1].astype(np.int64) ^ (rec[:, 3].astype(np.int64) * 0x9E3779B9)
    ) & 0x7FFFFFFFFFFFFFFF
    bucket = (pair % n_shards).astype(np.int64)

    # placement into per-(source, destination) blocks of equal capacity blk
    # (the exchange's blocks are uniform; with pair-bucketing the block
    # occupancies are near-uniform, so blk stays close to the mean, not the
    # hot-cb max)
    shard_arr = np.asarray(src_shard, dtype=np.int64)
    group = shard_arr * n_shards + bucket
    counts = np.bincount(group, minlength=n_shards * n_shards)
    blk = max(1, int(counts.max()))
    order = np.argsort(group, kind="stable")
    sorted_group = group[order]
    starts = np.zeros_like(counts)
    starts[1:] = np.cumsum(counts)[:-1]
    within = np.arange(n_total, dtype=np.int64) - starts[sorted_group]
    dest_shard = sorted_group // n_shards
    dest_row = (sorted_group % n_shards) * blk + within

    rows_arr = np.zeros((n_shards, n_shards * blk, width), dtype=np.int32)
    valid_arr = np.zeros((n_shards, n_shards * blk), dtype=bool)
    rows_arr[dest_shard, dest_row] = rec[order]
    valid_arr[dest_shard, dest_row] = True
    stats["blk"] = blk
    stats["buffer_rows"] = int(rows_arr.shape[0] * rows_arr.shape[1])
    t_place = time.perf_counter()

    shards = cb_bucket_all_to_all(devices, torch.from_numpy(rows_arr), torch.from_numpy(valid_arr))
    t_exchange = time.perf_counter()
    runlog().event("report_distributed", shards=n_shards, devices=[str(d) for d in devices], rows=n_total,
                   blk=blk, buffer_rows=stats["buffer_rows"], place_s=round(t_place - t0, 4),
                   exchange_s=round(t_exchange - t_place, 4))

    # hash -> string decode via sorted 64-bit keys
    cb_keys = _combined_key(cb_hash)
    cb_order = np.argsort(cb_keys)
    umi_keys = _combined_key(umi_hash)
    umi_order = np.argsort(umi_keys)

    def decode(words: np.ndarray, keys, key_order, names) -> np.ndarray:
        pos = np.searchsorted(keys[key_order], _combined_key(words))
        return names[key_order[pos]]

    # each shard now owns disjoint (cb, umi) pairs: run the device pipeline
    # per shard on its device, then sum per (cb, feature) at the merge
    merged: Dict[Tuple[str, str], int] = {}
    dropped_total = 0
    for s, (rows_s, valid_s) in enumerate(shards):
        recs = rows_s[valid_s].cpu().numpy()
        if recs.shape[0] == 0:
            continue
        cbs = decode(recs[:, 0:2], cb_keys, cb_order, uniq_cb).tolist()
        umis = decode(recs[:, 2:4], umi_keys, umi_order, uniq_umi).tolist()
        bits = recs[:, 4 : 4 + W]
        scores = recs[:, 4 + W].view(np.float32).astype(np.float64)
        counts_s, dropped = report_device(
            cbs, umis, bits, scores, feature_names, threshold,
            disable_thresholding, with_dropped=True, device=devices[s],
        )
        dropped_total += dropped
        for feature, count, cb in counts_s:
            merged[(cb, feature)] = merged.get((cb, feature), 0) + count

    rows = [(feature, c, cb) for (cb, feature), c in sorted(merged.items())]
    out = (rows,)
    if with_dropped:
        out += (dropped_total,)
    if with_stats:
        out += (stats,)
    return out if len(out) > 1 else rows
