"""The data x feature device grid of `align --mesh` (nimble_tpu/parallel/
mesh.py), as a plain grid of torch devices.

  "data"    — read-batch parallelism: each chunk is cut into n_data row
              blocks, and block d runs a one-device align step on data row
              d's lead device (its feature-0 device).
  "feature" — the class-bitset words split across a row's devices: every
              device of the row holds the index tables, but only a slice of
              the (n_classes, W) class-bitset matrix. The AND-intersection is
              elementwise over W, so each slice intersects on its own device
              and the slices meet on the row's lead device, concatenated
              along the words.

The reference places its arrays with NamedSharding and lets the SPMD
partitioner split one program; here the engine issues one step per data row
(align/engine.py: AlignEngine(mesh=)), and `shard_tables` copies every table
once per distinct device.

Devices for the CLI (`align_mesh`): on cuda every visible card, cuda:0 ..
cuda:n-1. On the CPU there is no device count to fill: an explicit
data=N[,feature=M] or a bare N takes exactly N*M CPU shards, as `report
--distributed N --device cpu` does; `auto`, or a data axis left to fill,
takes one data shard. (The reference fills from the CPU device count XLA was
forced to, 8 under its tests.)
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# the reference's per-chip budget when no device says otherwise
DEFAULT_HBM_BYTES = 12 << 30


class MeshPlan:
    """An (n_data, n_feature) grid of torch devices; a device may appear
    more than once (several shards on one card, or CPU shards)."""

    def __init__(self, grid: Sequence[Sequence[torch.device]]):
        self.grid: Tuple[Tuple[torch.device, ...], ...] = tuple(
            tuple(torch.device(d) for d in row) for row in grid)
        if not self.grid or not self.grid[0] or len({len(r) for r in self.grid}) != 1:
            raise ValueError(f"a mesh needs a non-empty rectangular grid, got {self.grid}")

    @property
    def n_data(self) -> int:
        return len(self.grid)

    @property
    def n_feature(self) -> int:
        return len(self.grid[0])

    @property
    def devices(self) -> List[torch.device]:
        """The grid's devices, row-major."""
        return [d for row in self.grid for d in row]

    def lead(self, d: int) -> torch.device:
        """Data row d's lead device: its feature-0 device."""
        return self.grid[d][0]


def visible_cards() -> List[torch.device]:
    """cuda:0 .. cuda:n-1, every visible card (none without CUDA)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_data: Optional[int] = None, n_feature: int = 1, devices=None) -> MeshPlan:
    """An (n_data, n_feature) grid over the first n_data * n_feature of
    `devices` (every visible card by default); n_data None fills the data
    axis. Raises ValueError when the grid needs more devices than the list
    holds."""
    devices = list(devices) if devices is not None else visible_cards()
    if n_data is None:
        n_data = len(devices) // max(n_feature, 1)
    if n_data < 1 or n_feature < 1:
        raise ValueError(f"mesh {n_data}x{n_feature} needs at least one device on each axis "
                         f"({len(devices)} {'is' if len(devices) == 1 else 'are'} visible: "
                         f"{[str(d) for d in devices]})")
    need = n_data * n_feature
    if need > len(devices):
        raise ValueError(f"mesh {n_data}x{n_feature} needs {need} devices, and {len(devices)} "
                         f"{'is' if len(devices) == 1 else 'are'} visible: {[str(d) for d in devices]}")
    return MeshPlan([devices[r * n_feature:(r + 1) * n_feature] for r in range(n_data)])


def parse_axes(spec: str) -> Optional[Tuple[Optional[int], int]]:
    """The axes of a mesh spec, (n_data or None to fill, n_feature), or None
    for an empty spec. Raises ValueError on an entry that is not axis=N or
    names another axis than data and feature."""
    if not spec:
        return None
    spec = spec.strip().lower()
    if spec == "auto":
        return None, 1
    if spec.isdigit():
        return int(spec), 1
    n_data = None
    n_feature = 1
    for part in spec.split(","):
        if not part:
            continue
        try:
            axis, _, value = part.partition("=")
            value = int(value)
        except ValueError:
            raise ValueError(f"bad mesh spec entry {part!r} (want axis=N)")
        if axis == "data":
            n_data = value
        elif axis == "feature":
            n_feature = value
        else:
            raise ValueError(f"unknown mesh axis {axis!r} (want data/feature)")
    return n_data, n_feature


def parse_mesh_spec(spec: str, devices=None) -> Optional[MeshPlan]:
    """The CLI mesh spec -> a MeshPlan over `devices` (every visible card by
    default). Accepted forms: "data=4,feature=2", "data=8", "feature=2"
    (data fills the remaining devices), a bare int "8" (all data), or
    "auto" (all devices on the data axis). Empty -> None (no mesh)."""
    axes = parse_axes(spec)
    if axes is None:
        return None
    n_data, n_feature = axes
    return make_mesh(n_data=n_data, n_feature=n_feature, devices=devices)


def align_mesh(spec: str, device: torch.device) -> Optional[MeshPlan]:
    """`align --mesh SPEC` on `device` (the module docstring's rule): every
    visible card on cuda; on the CPU exactly the N*M shards an explicit
    data axis names, or one data row where the data axis is left to fill."""
    axes = parse_axes(spec)
    if axes is None:
        return None
    n_data, n_feature = axes
    if torch.device(device).type == "cpu":
        n_data = 1 if n_data is None else n_data
        return make_mesh(n_data, n_feature, [torch.device("cpu")] * max(n_data * n_feature, 0))
    return make_mesh(n_data, n_feature, visible_cards())


def pad_axis(arr, axis: int, multiple: int, fill=0):
    """Pad `axis` of a numpy array or a torch tensor up to a multiple of
    `multiple` with `fill`."""
    size = arr.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return arr
    if isinstance(arr, torch.Tensor):
        pad = [0, 0] * (arr.dim() - 1 - axis) + [0, target - size]
        return F.pad(arr, pad, value=fill)
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, target - size)
    return np.pad(arr, pad, constant_values=fill)


def plan_index_placement(index, hbm_bytes_per_chip: Optional[int] = None, n_chips: int = 1, device=None):
    """Replicate-vs-shard planner for an index against the per-device
    memory budget: replicate the hash tables and shard the read stream, and
    split the class-bitset matrix over the feature axis only when it must
    spill (0.6 of the memory for tables, feature shards doubled until they
    fit, at most n_chips). hbm_bytes_per_chip None takes the card's memory
    (`device`, default the current card) on cuda, the reference's 12 GiB
    on the CPU. Placement only: the output does not depend on it.

    Returns {"table_bytes", "class_bytes", "replicate_table",
    "feature_shards", "fits"}: feature_shards == 1 means fully replicated."""
    if hbm_bytes_per_chip is None:
        dev = torch.device(device) if device is not None else (
            torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
        hbm_bytes_per_chip = (torch.cuda.get_device_properties(dev).total_memory
                              if dev.type == "cuda" else DEFAULT_HBM_BYTES)
    table_bytes = int(index.table_hi.nbytes + index.table_lo.nbytes
                      + index.table_vsame.nbytes + index.table_vdiff.nbytes)
    class_bytes = int(index.class_bits.nbytes)
    budget = int(hbm_bytes_per_chip * 0.6)  # room for batches and workspace

    feature_shards = 1
    while table_bytes + class_bytes // feature_shards > budget:
        feature_shards *= 2
        if feature_shards > max(1, n_chips):
            break
    fits = table_bytes + class_bytes // feature_shards <= budget
    return {
        "table_bytes": table_bytes,
        "class_bytes": class_bytes,
        "replicate_table": True,
        "feature_shards": min(feature_shards, max(1, n_chips)),
        "fits": fits,
    }


def shard_tables(tables: dict, plan: MeshPlan) -> List[dict]:
    """Place a one-device table set on the mesh -> one table set per data
    row, on its lead device. Every tensor is copied once per distinct
    device (a grid that names one card four times holds one copy). With
    n_feature > 1, `class_bits` is padded to a multiple of n_feature words
    and its column slice f goes to grid column f's devices, as the tuple
    `class_slices`, with the padded width as `class_words`; a banded class
    table (`class_words` without `class_bits`) keeps its bands whole and
    reports the padded width, which its expansion fills with zero words."""
    copies = {}

    def on(key, t, dev):
        if (key, dev) not in copies:
            copies[(key, dev)] = t.to(dev)
        return copies[(key, dev)]

    M = plan.n_feature
    slices = None
    if M > 1 and "class_bits" in tables:
        cb = pad_axis(tables["class_bits"], 1, M)
        w = cb.shape[1] // M
        slices = [cb[:, f * w:(f + 1) * w].contiguous() for f in range(M)]
    out = []
    for d in range(plan.n_data):
        lead = plan.lead(d)
        row = {k: on(k, v, lead) if isinstance(v, torch.Tensor) else v
               for k, v in tables.items() if not (slices is not None and k == "class_bits")}
        if slices is not None:
            row["class_slices"] = tuple(on(("class_slice", f), s, plan.grid[d][f]) for f, s in enumerate(slices))
            row["class_words"] = sum(s.shape[1] for s in slices)
        elif M > 1 and "class_words" in tables:
            row["class_words"] = -(-int(tables["class_words"]) // M) * M
        out.append(row)
    return out
