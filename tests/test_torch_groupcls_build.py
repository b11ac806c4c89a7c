"""The groupcls table built in torch on the engine's device
(nimble_tpu_torch/align/tables.py: groupcls_entries, build_groupcls_tables)
against the reference's numpy build (nimble_tpu/align/engine.py:
_build_groupcls_tables), element for element: on the suite's groupcls
libraries, with a stash forced by the placement's constants, and where
placement blows its budget (device_tables then takes the reference's
path). The card's build against the CPU's runs only where a card is
visible."""
import json

import numpy as np
import pytest
import torch

from benchmark import gen, spec
from nimble_tpu.align import engine as E
from nimble_tpu.config import Config
from nimble_tpu_torch.align import tables as TT
from tests.test_torch_gband import _same_tables, groupcls_seqs, make_data
from tests.test_torch_hla20k import CUT, LENGTH
from tests.test_torch_host_parity import build_both
from tests.test_torch_tables import _synthetic_index
from tests.test_torch_wide import w19_seqs

CPU = torch.device("cpu")


def _hla20k_cut():
    """test_torch_hla20k.py's 700-allele cut of the hla20k library (W = 22)."""
    cfg = json.loads((spec.HERE / "configs" / "hla20k.json").read_text())
    lib = dict(cfg["library"], length=LENGTH)
    lib["loci"] = [dict(x, alleles=n) for x, n in zip(lib["loci"], CUT)]
    al = gen.library_alleles(lib)
    seqs = [c[:n] for c, n in zip(al["codes"], al["lens"])]
    return build_both(make_data(seqs), Config(), k=cfg["k"], group_g=cfg["g"])


# name -> (reference index, port index), each a library the suite sends down groupcls
LIBRARIES = {
    "groupcls": lambda: build_both(make_data(groupcls_seqs()), Config(), k=21),
    "w19": lambda: build_both(make_data(w19_seqs()), Config(), k=21),
    "synthetic": lambda: _synthetic_index(n_seqs=600, length=60),
    "hla20k-cut": _hla20k_cut,
}


@pytest.fixture(scope="module")
def libs():
    return {}


def _lib(libs, name):
    if name not in libs:
        libs[name] = LIBRARIES[name]()
    return libs[name]


def _build(port, device=CPU):
    """(the port's groupcls tables as numpy arrays or None, the build's info)."""
    entries = TT.groupcls_entries(port)
    tables, info = TT.build_groupcls_tables({k: torch.from_numpy(v).to(device) for k, v in entries.items()})
    return None if tables is None else {k: v.cpu().numpy() for k, v in tables.items()}, info


def _assert_equal(got, want):
    assert set(got) == set(TT.GROUPCLS_KEYS)
    for k in TT.GROUPCLS_KEYS:
        assert got[k].dtype == np.int32 and np.array_equal(got[k], np.asarray(want[k])), k


def _set(monkeypatch, **constants):
    for name, value in constants.items():
        monkeypatch.setattr(E, name, value)
        monkeypatch.setattr(TT, name, value)


@pytest.mark.parametrize("name", list(LIBRARIES))
def test_device_build_equals_the_reference(libs, name):
    """Bucket and stash planes equal the reference's, and the info counts
    what was built."""
    ref, port = _lib(libs, name)
    assert ref.bitset_words > TT.INLINE_BITS_MAX_WORDS and TT.build_class_bands_robust(port) is None
    got, info = _build(port)
    _assert_equal(got, E._build_groupcls_tables(ref))
    n = port.pair_hi.shape[0]
    assert info["entries"] == n and info["buckets"] == got["groupcls_bucket"].shape[0]
    assert info["buckets"] in TT._bucket_sizes(n, 2 + 2 * port.pair_g + 1)[: info["rounds"]]
    assert info["stash"] == int((got["groupcls_stash_hi"] != -1).sum())
    assert info["bytes"] == sum(a.nbytes for a in got.values())


@pytest.mark.parametrize("rounds", [1, 6])
def test_forced_stash_equals_the_reference(libs, monkeypatch, rounds):
    """No round is tight enough to stop the growth: every bucket size the
    budget allows is tried and the one with the fewest overflows kept (the
    first of equals). Under a budget of one size the final round keeps its
    overflow rows in the stash, in the reference's order."""
    ref, port = _lib(libs, "groupcls")
    entry = 2 + 2 * port.pair_g + 1
    sizes = TT._bucket_sizes(port.pair_hi.shape[0], entry)
    _set(monkeypatch, MONO_TIGHT_STASH=-1, MONO_MAX_BYTES=sizes[rounds - 1] * TT.MONO_SLOTS * entry * 4)
    got, info = _build(port)
    _assert_equal(got, E._build_groupcls_tables(ref))
    assert info["rounds"] == rounds
    if rounds == 1:
        assert info["stash"] == 6 and (got["groupcls_stash_hi"] != -1).all()


@pytest.mark.parametrize("blown", ["bytes", "stash"])
def test_blown_budget_takes_the_reference_path(libs, monkeypatch, blown):
    """No bucket size fits MONO_MAX_BYTES (the host refuses the entries) or
    every size overflows MONO_MAX_STASH (the device build gives None):
    device_tables then ships the reference's tables, on the path it takes."""
    ref, port = _lib(libs, "groupcls")
    if blown == "bytes":
        _set(monkeypatch, MONO_MAX_BYTES=1 << 16)
        assert TT.groupcls_entries(port) is None
    else:
        entry = 2 + 2 * port.pair_g + 1
        first = TT._bucket_sizes(port.pair_hi.shape[0], entry)[0]
        _set(monkeypatch, MONO_MAX_STASH=0, MONO_TIGHT_STASH=-1, MONO_MAX_BYTES=first * TT.MONO_SLOTS * entry * 4)
        tables, info = _build(port)
        assert tables is None and info["stash"] == 6 and info["bytes"] == 0
    assert E._build_groupcls_tables(ref) is None
    want = {k: np.asarray(v) for k, v in E._device_tables(ref).items()}
    got = TT.device_tables(port, CPU)
    assert "groupcls_bucket" not in got
    _same_tables(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["groupcls", "hla20k-cut"])
def test_card_build_equals_the_cpu_build(libs, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, port = _lib(libs, name)
    got, info = _build(port, torch.device("cuda"))
    want, want_info = _build(port)
    assert info == want_info
    for k in TT.GROUPCLS_KEYS:
        assert np.array_equal(got[k], want[k]), k
