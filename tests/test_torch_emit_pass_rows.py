"""The port's emission resolves only a chunk's passing rows
(`LibraryRunner.emit_out`), and its TSV bytes are those of the
reference's resolve of every row: on the three wires (dense `bits`, gband
`band_rows`, idlist `ids`), with the native row formatter and the python
fallback, on chunks
whose failing rows share classes with passing rows or hold classes of
their own, with all-zero rows, and on chunks where no row or every row
passes. On the group path a read that the short-read repair turns to
passing is written, as the reference writes it."""
import dataclasses
import io
import json
import shutil

import numpy as np
import pytest

from nimble_tpu.__main__ import main as ref_cli
from nimble_tpu.align import pipeline as RP
from nimble_tpu.io.fastq import write_fastq
from nimble_tpu_torch import observability as obs
from nimble_tpu_torch.__main__ import main as port_cli
from nimble_tpu_torch.align import pipeline as P
from nimble_tpu_torch.align.engine import expand_band_rows_np, ids_to_bits_np
from nimble_tpu_torch.io import native
from tests.test_torch_host_parity import GOLD, native_in_both

N_FEATURES, W, PW, CAP = 250, 8, 2, 12  # 250 features in 8 words; band pages of 2 words


class FakeIndex:
    n_features = N_FEATURES
    bitset_words = W
    feature_names = [f"allele{i:03d}" for i in range(N_FEATURES)]
    feature_to_group = np.arange(N_FEATURES) // 5
    group_names = [f"G{g:02d}" for g in range(N_FEATURES // 5)]


def class_pool(rng):
    """Feature-id sets, each inside one band page pair (page * 64 to
    page * 64 + 127) and at most CAP ids: the empty class, classes of 5
    and 10 features in 1 and 2 groups (over max_hits_to_report by their
    features, under it by their groups), singletons, pairs, and classes
    over the set-size filters."""
    pool = [np.zeros(0, dtype=np.int64), np.arange(100, 105), np.arange(200, 210)]
    for size in [1] * 8 + [2] * 8 + [3] * 4 + [5, 7, 11, 12]:
        page = int(rng.integers(0, 4))
        lo, hi = page * 64, min(page * 64 + 128, N_FEATURES)
        pool.append(np.sort(rng.choice(np.arange(lo, hi), size=size, replace=False)))
    return pool


def encode(ids, wire):
    """One class as a row of the wire: (W,) bits, (1 + 2 PW,) band row or
    (CAP,) ids."""
    if wire == "ids":
        row = np.full(CAP, -1, dtype=np.int32)
        row[: ids.size] = ids
        return row
    bits = np.zeros(W, dtype=np.uint32)
    for f in ids:
        bits[f // 32] |= np.uint32(1 << (f % 32))
    bits = bits.view(np.int32)
    if wire == "bits":
        return bits
    page = int(ids.min()) // (32 * PW) if ids.size else 2  # an empty row on some page
    band = np.zeros(2 * PW, dtype=np.int32)
    n = min(2 * PW, W - page * PW)
    band[:n] = bits[page * PW : page * PW + n]
    return np.concatenate([[page], band]).astype(np.int32)


def make_chunk(wire, kind, seed):
    """A chunk of 400 rows on one wire. `mixed`: passing rows, failing rows
    of the passing rows' classes, failing rows of classes no passing row
    holds, all-zero rows passing and failing; `none`: nothing passes;
    `all`: every row passes."""
    rng = np.random.default_rng(seed)
    pool = class_pool(rng)
    n = 400
    shared, own = np.arange(0, 20), np.arange(20, len(pool))  # 0 is the empty class
    cls = rng.choice(shared, size=n)
    if kind == "mixed":
        pass_ = rng.random(n) < 0.3
        fail_only = rng.random(n) < 0.3
        cls = np.where(~pass_ & fail_only, rng.choice(own, size=n), cls)
        cls[:4] = 0
        pass_[:4] = [True, False, True, False]
        assert set(cls[~pass_]) & set(cls[pass_]) and set(cls[~pass_]) - set(cls[pass_])
    else:
        cls = rng.choice(np.arange(len(pool)), size=n)
        pass_ = np.full(n, kind == "all")
    rows = np.stack([encode(pool[c], wire) for c in cls])
    out = {"pass_": pass_, "score": rng.integers(0, 201, size=n).astype(np.int32),
           "r1_fwd": rng.integers(0, 101, size=n).astype(np.int32),
           "r2_fwd": rng.integers(0, 101, size=n).astype(np.int32)}
    if wire == "ids":
        out["ids"] = rows
        dense = ids_to_bits_np(rows, W)
    elif wire == "band":
        out["band_rows"], out["band_meta"] = rows, (PW, W)
        dense = expand_band_rows_np(rows, PW, W)
    else:
        out["bits"] = dense = rows
    return out, dense, n


def tags(n, tagged):
    if not tagged:
        return {}
    return {"cbs": [f"CB{i % 97:014d}" if i % 5 else "" for i in range(n)],
            "umis": np.array([f"U{i % 811:09d}" for i in range(n)]),
            "gns": ["" if i % 3 else f"Gene{i % 50}" for i in range(n)],
            "poss": [(i % 1000, -1 if i % 7 == 0 else (i * 3) % 1000) for i in range(n)]}


def want_bytes(dense, out, batch, emit):
    """The TSV of the reference's resolve of every row, dense bitsets
    decoded whole (`nimble_tpu.align.pipeline.resolve_features`), written
    for the rows that pass."""
    feats, keep = RP.resolve_features(FakeIndex(), dense, RP.EmitConfig(**dataclasses.asdict(emit)))
    lines = []
    for i in np.flatnonzero(keep & out["pass_"]):
        cb = batch["cbs"][i] if batch else ""
        umi = batch["umis"][i] if batch else ""
        pos1, pos2 = batch["poss"][i] if batch else ("", "")
        gn = batch["gns"][i] if batch else ""
        lines.append(f"{feats[i]}\t{out['score'][i]}\t{cb}\t{umi}\t{cb}\t{umi}\t{pos1}\t{pos2}\t"
                     f"{out['r1_fwd'][i]}\t{out['r2_fwd'][i]}\t{gn}\n")
    return "".join(lines).encode(), len(lines)


EMITS = {"bulk": (P.EmitConfig(False, False, 0, 10), False),
         "group_on-tagged": (P.EmitConfig(True, False, 0, 3), True),
         "discard-multiple": (P.EmitConfig(False, True, 0, 10), True)}


@pytest.fixture(scope="module")
def has_native():
    return native_in_both()


@pytest.mark.parametrize("formatter", ["native", "python"])
@pytest.mark.parametrize("emit_case", sorted(EMITS))
@pytest.mark.parametrize("kind", ["mixed", "none", "all"])
@pytest.mark.parametrize("wire", ["bits", "band", "ids"])
def test_pass_rows_resolve_writes_the_all_rows_bytes(has_native, monkeypatch, wire, kind, emit_case, formatter):
    if formatter == "native":
        assert has_native and native.available()
    else:
        monkeypatch.setattr(native, "available", lambda: False)
    emit, tagged = EMITS[emit_case]
    out, dense, n = make_chunk(wire, kind, seed=11)
    batch = tags(n, tagged)
    want, n_want = want_bytes(dense, out, batch, emit)
    r = P.LibraryRunner(None, FakeIndex(), None, emit, "x")
    r._file = io.BytesIO()
    got = r.emit_out(out, batch)
    assert r._file.getvalue() == want
    assert got == r.rows_written == n_want
    assert r.resolved_rows == np.count_nonzero(out["pass_"])
    if kind == "mixed":
        assert 0 < n_want < r.resolved_rows < n  # some passing rows drop, not vacuous
    elif kind == "all":
        assert n_want > 0


def _short_fastq(path, length):
    """The golden R1 reads with every third cut to `length` bases."""
    lines = (GOLD / "r1.fastq").read_text().splitlines()
    recs = []
    for i in range(0, len(lines), 4):
        s, q = lines[i + 1], lines[i + 3]
        if (i // 4) % 3 == 0:
            s, q = s[:length], q[:length]
        recs.append((lines[i][1:], s, q))
    write_fastq(str(path), recs)


def test_group_path_writes_the_rows_the_short_read_patch_passes(tmp_path, monkeypatch, capsys):
    """Reads of 25 bases, under k + g - 1 = 26, come back unmapped from the
    group probe; the host repair passes some, and they are written: the
    port's TSV is the reference's, and holds more rows than the same run
    without the repair."""
    from nimble_tpu_torch.align import host_probe

    native_in_both()
    shutil.copy(GOLD / "lib_base.json", tmp_path / "lib_base.json")
    fq = tmp_path / "short.fastq"
    _short_fastq(fq, 25)

    def run(cli, name, extra=()):
        out = tmp_path / f"{name}.tsv"
        rc = cli(["align", "--reference", str(tmp_path / "lib_base.json"), "--output", str(out),
                  "--input", str(fq), *extra])
        assert rc == 0, name
        return out.read_bytes()

    ref = run(ref_cli, "ref")
    log = tmp_path / "port.jsonl"
    monkeypatch.setattr(obs, "_GLOBAL", obs.RunLog(str(log)))
    try:
        port = run(port_cli, "port", ["--device", "cpu"])
    finally:
        obs._GLOBAL.close()
        monkeypatch.setattr(obs, "_GLOBAL", None)
    assert port == ref
    events = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert sum(e["rows"] for e in events if e["event"] == "short_read_patch") > 0
    assert [e["path"] for e in events if e["event"] == "engine"] == ["group"]

    monkeypatch.setattr(host_probe, "patch_short_reads", lambda *a, **kw: 0)
    unpatched = run(port_cli, "unpatched", ["--device", "cpu"])
    assert port.count(b"\n") > unpatched.count(b"\n") > 1
