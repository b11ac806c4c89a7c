"""The port's group-probe tables (nimble_tpu_torch/align/tables.py) against
the reference's `_device_tables(index)` group entries, element for element.
The mono and two-choice tables are held in tests/test_torch_mono.py."""
import pathlib

import numpy as np
import pytest
import torch

from nimble_tpu.align.engine import _device_tables
from nimble_tpu.config import Config, Data, load_library
from nimble_tpu.index.builder import build_index
from nimble_tpu_torch.align.tables import (
    GROUP_KEYS,
    build_group_tables,
    device_tables,
    table_words,
    tables_from_reference,
)

GOLD = pathlib.Path(__file__).resolve().parent / "goldens"


def _golden_index():
    config, data = load_library(str(GOLD / "lib_base.json"))
    return build_index(data, config)


def _synthetic_index(seed: int = 2, n_seqs: int = 60, length: int = 400):
    rng = np.random.default_rng(seed)
    data = Data()
    for i in range(n_seqs):
        s = "".join("ACGT"[j] for j in rng.integers(0, 4, size=length))
        data.columns[0].append("lib")
        data.columns[1].append(f"f{i}")
        data.columns[2].append(str(len(s)))
        data.columns[3].append(s)
    return build_index(data, Config())


@pytest.mark.parametrize("make_index", [_golden_index, _synthetic_index], ids=["golden", "synthetic"])
def test_group_tables_equal_reference(make_index):
    index = make_index()
    ref = {k: np.asarray(v) for k, v in _device_tables(index).items() if k in GROUP_KEYS}
    assert set(ref) == set(GROUP_KEYS)
    got = build_group_tables(index)
    dev = device_tables(index, torch.device("cpu"))
    for k in GROUP_KEYS:
        assert got[k].dtype == np.int32 and np.array_equal(got[k], ref[k]), k
        assert dev[k].dtype == torch.int32 and np.array_equal(dev[k].numpy(), ref[k]), k
    assert table_words(dev) == index.bitset_words


def test_synthetic_library_has_a_stash():
    """The synthetic case places keys in the overflow stash, so the stash
    comparison above is not vacuous."""
    index = _synthetic_index()
    got = build_group_tables(index)
    assert (got["group_stash_hi"] != -1).sum() > 0
    assert index.bitset_words == 2


def test_tables_from_reference_carries_group_entries():
    index = _golden_index()
    ref = _device_tables(index)
    got = tables_from_reference({k: np.asarray(v) for k, v in ref.items()}, torch.device("cpu"))
    assert set(got) == set(GROUP_KEYS)
    for k in GROUP_KEYS:
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), k
    with pytest.raises(ValueError, match="no group, mono or two-choice entries"):
        tables_from_reference({"bucket": np.zeros((1, 16), np.int32)}, torch.device("cpu"))


def test_device_tables_refuse_what_the_group_path_cannot_take():
    """A mono index (no group entries) or group_ok=False gets the mono
    table, as the reference's _device_tables gives it; a W > 16 library the
    reference takes to its groupcls path (unbanded) raises, naming the
    ROADMAP item."""
    index = _golden_index()
    config, data = load_library(str(GOLD / "lib_base.json"))
    mono = build_index(data, config, group_g=0)
    cpu = torch.device("cpu")
    assert set(device_tables(mono, cpu)) == {"mono_bucket", "mono_stash"}
    assert set(device_tables(index, cpu, group_ok=False)) == {"mono_bucket", "mono_stash"}
    assert set(device_tables(index, cpu)) == set(GROUP_KEYS)
    wide = _synthetic_index(n_seqs=600, length=60)
    assert wide.bitset_words > 16
    with pytest.raises(NotImplementedError, match="groupcls.*Queue 1 item 10"):
        device_tables(wide, cpu)
