"""The port's stacked multi-library engine (nimble_tpu_torch/align/stacked.py)
against the reference's (nimble_tpu/align/stacked.py) and against the
per-library engines, on the CPU: the merged tables array for array (before
the mono table's re-lay), the engine's outputs key for key on the same
reads, the stacking and group gates, and the `align` TSVs of the port
stacked (NIMBLE_TPU_STACK=1), the port by default (one engine per library)
and the reference CLI, byte for byte. Modelled on tests/test_stacked.py."""
import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from nimble_tpu import seq as seqmod
from nimble_tpu.__main__ import main as ref_cli
from nimble_tpu.align import stacked as RS
from nimble_tpu.config import Config
from nimble_tpu_torch import observability
from nimble_tpu_torch.__main__ import main as port_cli
from nimble_tpu_torch.align import engine as T
from nimble_tpu_torch.align import stacked as TS
from nimble_tpu_torch.align.pipeline import append_path_string
from nimble_tpu_torch.config import Config as PortConfig
from tests.test_stacked import make_data, make_reads, rand_seq
from tests.test_torch_host_parity import build_both

CPU = torch.device("cpu")
K = 15


def port_config(config: Config) -> PortConfig:
    return PortConfig(**dataclasses.asdict(config))


def both_libs(seq_lists, configs, **kw):
    """Each library's index in both packages (build_both) -> (reference
    indexes, port indexes, reference configs, port configs)."""
    built = [build_both(make_data(s), c, k=K, **kw) for s, c in zip(seq_lists, configs)]
    return [b[0] for b in built], [b[1] for b in built], list(configs), [port_config(c) for c in configs]


def three_libs(rng):
    """tests/test_stacked.py:make_libs's three libraries and configs: W = 1,
    2 and 1, shared k-mers across them, a score threshold with
    intersect_level 1 on the second and require_valid_pair on the third."""
    base = rand_seq(rng, 600)
    lib_a = [base[i : i + 200] for i in range(0, 400, 40)]
    lib_b = [base[100:300], rand_seq(rng, 300)] + [rand_seq(rng, 120) for _ in range(38)]
    lib_c = [base[50:250] + rand_seq(rng, 50)]
    cfg_b = Config(score_threshold=30, intersect_level=1)
    cfg_c = Config(require_valid_pair=True)
    configs = [Config(), cfg_b, cfg_c]
    for c in configs:
        c.kmer_length = K
    return (*both_libs([lib_a, lib_b, lib_c], configs), lib_a + lib_b[:2] + lib_c)


@pytest.fixture(scope="module")
def libs3():
    return three_libs(np.random.default_rng(11))


@pytest.fixture(scope="module")
def wide47():
    """A library of 1,480 features (W = 47) next to a narrow one: the
    stack is W_cat = 48 words, wider than the group gate allows, so it takes
    the mono stack."""
    rng = np.random.default_rng(47)
    wide = [rand_seq(rng, 40) for _ in range(1480)]
    narrow = [rand_seq(rng, 200) for _ in range(3)]
    configs = [Config(kmer_length=K), Config(kmer_length=K)]
    return both_libs([wide, narrow], configs), wide + narrow


def _keys(hi, lo):
    """(hi, lo) int32 bit patterns -> uint64 keys."""
    return (np.asarray(hi).view(np.uint32).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).view(
        np.uint32).astype(np.uint64)


def _assert_same_tables(want, got):
    assert want is not None and got is not None
    assert set(want) == set(got)
    for key, v in want.items():
        if isinstance(v, tuple) or np.isscalar(v):
            assert got[key] == v, key
        else:
            w = np.asarray(v)
            assert got[key].dtype == w.dtype and np.array_equal(got[key], w), key


@pytest.mark.parametrize("which", ["three", "shared", "wide47"])
def test_stacked_tables_equal_reference(libs3, wide47, which):
    """build_stacked_tables and build_stacked_group_tables give the
    reference's arrays (the mono table in its planar layout, before the
    port's re-lay), seg_words and pair_g; every distinct canonical key of
    the libraries is placed or stashed once (tests/test_stacked.py:106,
    :135), and a library's mask word is nonzero exactly where it holds
    the key."""
    if which == "three":
        ref_ix, port_ix = libs3[:2]
    elif which == "wide47":
        ref_ix, port_ix = wide47[0][0], wide47[0][1]
    else:
        rng = np.random.default_rng(5)
        shared = rand_seq(rng, 100)
        ref_ix, port_ix, _, _ = both_libs([[shared], [shared, rand_seq(rng, 80)]], [Config(), Config()])
    mono = TS.build_stacked_tables(port_ix)
    group = TS.build_stacked_group_tables(port_ix)
    _assert_same_tables(RS.build_stacked_tables(ref_ix), mono)
    _assert_same_tables(RS.build_stacked_group_tables(ref_ix), group)
    assert mono["seg_words"] == tuple(np.cumsum([0] + [ix.bitset_words for ix in port_ix]))

    S = TS.STACK_SLOTS
    union = np.unique(np.concatenate([TS._lib_entries(ix)[0] for ix in port_ix]))
    b = mono["mono_bucket"]
    placed = _keys(b[:, :S], b[:, S : 2 * S])[b[:, :S] != -1]
    stashed = _keys(mono["mono_stash_hi"], mono["mono_stash_lo"])[mono["mono_stash_hi"] != -1]
    assert np.array_equal(np.sort(np.concatenate([placed, stashed])), union)

    pair_keys = [_keys(ix.pair_hi, ix.pair_lo) for ix in port_ix]
    W_cat = mono["seg_words"][-1]
    b = group["sg_bucket"]
    occ = b[:, :S] != -1
    held_keys = _keys(b[:, :S], b[:, S : 2 * S])
    stashed = _keys(group["sg_stash_hi"], group["sg_stash_lo"])[group["sg_stash_hi"] != -1]
    assert np.array_equal(np.sort(np.concatenate([held_keys[occ], stashed])), np.unique(np.concatenate(pair_keys)))
    for li, keys in enumerate(pair_keys):
        m = b[:, 2 * S + 2 * W_cat * S + li * S : 2 * S + 2 * W_cat * S + (li + 1) * S]
        assert np.array_equal((m != 0) & occ, np.isin(held_keys, keys) & occ)


def _reads(src, paired: bool, seed: int, n: int = 64, L: int = 80):
    """tests/test_stacked.py:make_reads from the libraries' sequences and
    unrelated ones (errors, N bases, half reverse-complemented)."""
    rng = np.random.default_rng(seed)
    src = src + [rand_seq(rng, 200) for _ in range(3)]
    r1, l1 = make_reads(rng, src, n, L)
    r2, l2 = make_reads(rng, src, n, L) if paired else (None, None)
    return r1, l1, r2, l2


def _assert_outputs_equal(want, got, what):
    assert len(want) == len(got)
    for li, (a, b) in enumerate(zip(want, got)):
        assert set(a) == set(b)
        for key in a:
            assert np.array_equal(np.asarray(a[key]), b[key]), f"{what}: library {li}, {key}"


ENGINE_CASES = {
    "group-se": dict(paired=False),
    "group-pe": dict(paired=True),
    "mono-se": dict(paired=False, mono=True),
    "mono-pe": dict(paired=True, mono=True),
    "group-fiveprime-pe": dict(paired=True, strand="fiveprime"),
    "mono-threeprime-se": dict(paired=False, mono=True, strand="threeprime"),
    "mono-stride2-se": dict(paired=False, stride=2),
    "mono-stride2-pe": dict(paired=True, stride=2),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_stacked_engine_matches_reference(libs3, monkeypatch, case):
    """The port's StackedEngine == the reference's StackedEngine, every
    library and every output key, exactly; and == each library's own port
    AlignEngine (tests/test_stacked.py:70). The mono stack is taken with
    NIMBLE_TPU_NO_GROUP_PROBE=1 or kmer_stride = 2."""
    c = ENGINE_CASES[case]
    ref_ix, port_ix, ref_cfg, port_cfg, src = libs3
    if c.get("mono"):
        monkeypatch.setenv("NIMBLE_TPU_NO_GROUP_PROBE", "1")
    if c.get("stride"):
        ref_cfg = [dataclasses.replace(x, kmer_stride=c["stride"]) for x in ref_cfg]
        port_cfg = [dataclasses.replace(x, kmer_stride=c["stride"]) for x in port_cfg]
    paired, strand = c["paired"], c.get("strand", "unstranded")
    r1, l1, r2, l2 = _reads(src, paired, seed=len(case))
    kw = dict(strand_filter=strand, chunk_size=32, max_len=80, paired=paired)
    ref = RS.StackedEngine(ref_ix, ref_cfg, **kw)
    eng = TS.StackedEngine(port_ix, port_cfg, CPU, **kw)
    assert eng.group_g == ref.group_g
    assert eng.path == ("stacked-mono" if c.get("mono") or c.get("stride") else "stacked-group")
    got = eng.align_batch(r1, l1, r2, l2)
    _assert_outputs_equal(ref.collect_async(ref.align_batch_async(r1, l1, r2, l2)), got, "reference")
    solo = [T.AlignEngine(ix, cfg, CPU, **kw) for ix, cfg in zip(port_ix, port_cfg)]
    _assert_outputs_equal([e.align_batch(r1, l1, r2, l2) for e in solo], got, "per-library")
    assert any(o["pass_"].any() for o in got)


def test_stacked_engine_dispatch_and_chunk(libs3, monkeypatch):
    """Packed-wire dispatch equals the code dispatch (the helper both
    engines share); the auto chunk is the reference's formula (the same
    words a read on both stacks, the same chunk under the CPU clamp), and a
    chunk_cap rounds it down to a power of two."""
    from nimble_tpu_torch.io.packing import pack_batch

    ref_ix, port_ix, ref_cfg, port_cfg, src = libs3
    r1, l1, r2, l2 = _reads(src, True, seed=3, n=100)
    eng = TS.StackedEngine(port_ix, port_cfg, CPU, chunk_size=32, max_len=80, paired=True)
    pb = pack_batch({"r1_codes": r1, "r1_lens": l1, "r2_codes": r2, "r2_lens": l2}, 80)
    _assert_outputs_equal(eng.align_batch(r1, l1, r2, l2),
                          eng.collect_async(eng.align_packed_async(pb)), "packed")
    assert eng.collect_async([]) is None
    per_read = []
    real = RS.E._chunk_from_per_read
    monkeypatch.setattr(RS.E, "_chunk_from_per_read", lambda n, paired: per_read.append(n) or real(n, paired))
    for paired, mono in ((False, False), (True, False), (True, True)):
        if mono:
            monkeypatch.setenv("NIMBLE_TPU_NO_GROUP_PROBE", "1")
        ref = RS.StackedEngine(ref_ix, ref_cfg, chunk_size=None, max_len=112, paired=paired)
        auto = TS.StackedEngine(port_ix, port_cfg, CPU, chunk_size=None, max_len=112, paired=paired)
        assert auto.chunk_size == ref.chunk_size and auto._per_read() == per_read[-1]
        assert auto.path == ("stacked-mono" if mono else "stacked-group")
    capped = TS.StackedEngine(port_ix, port_cfg, CPU, chunk_size=None, max_len=112, chunk_cap=100)
    assert capped.chunk_size == 64
    # on the card the CPU clamp does not apply
    assert T.chunk_from_per_read(auto._per_read(), True, torch.device("cuda")) > auto.chunk_size
    assert eng.wire == "full" and eng.table_bytes == sum(t.numel() * 4 for t in eng.tables.values())


def test_compatible_gates(libs3):
    """StackedEngine.compatible agrees with the reference's: equal k and
    stride, and at most STACK_MAX_WORDS words in all."""
    ref_ix, port_ix, ref_cfg, port_cfg, _ = libs3
    stride2 = Config(kmer_stride=2)
    narrow = types.SimpleNamespace(k=K, bitset_words=30)
    cases = [
        (ref_ix, ref_cfg, port_ix, port_cfg, True),
        (ref_ix, [ref_cfg[0], ref_cfg[1], stride2], port_ix, [port_cfg[0], port_cfg[1], port_config(stride2)],
         False),
        ([narrow, narrow], [Config()] * 2, [narrow, narrow], [PortConfig()] * 2, True),
        ([narrow, narrow, narrow], [Config()] * 3, [narrow] * 3, [PortConfig()] * 3, False),  # 90 words
        ([narrow, types.SimpleNamespace(k=K + 2, bitset_words=1)], [Config()] * 2,
         [narrow, types.SimpleNamespace(k=K + 2, bitset_words=1)], [PortConfig()] * 2, False),
    ]
    for rix, rcfg, pix, pcfg, want in cases:
        assert RS.StackedEngine.compatible(rix, rcfg) == want
        assert TS.StackedEngine.compatible(pix, pcfg) == want


GATE_CASES = ["default", "max-len-short", "no-group-env", "stride2", "wide-w9", "no-group-entries",
              "two-g"]


@pytest.mark.parametrize("case", GATE_CASES)
def test_group_gate_matches_reference(libs3, monkeypatch, case):
    """The stack takes the group probe exactly where the reference's does
    (stacked.py:468-479): every library with group entries of one g, at W
    <= GROUP_MAX_WORDS and stride 1, reads at least k+g-1 long and
    NIMBLE_TPU_NO_GROUP_PROBE unset; else the mono stack, with the same
    tables."""
    ref_ix, port_ix, ref_cfg, port_cfg, _ = libs3
    max_len = 80
    rng = np.random.default_rng(9)
    if case == "max-len-short":
        max_len = K + ref_ix[0].pair_g - 2
    elif case == "no-group-env":
        monkeypatch.setenv("NIMBLE_TPU_NO_GROUP_PROBE", "1")
    elif case == "stride2":
        ref_cfg = [dataclasses.replace(x, kmer_stride=2) for x in ref_cfg]
        port_cfg = [dataclasses.replace(x, kmer_stride=2) for x in port_cfg]
    elif case == "wide-w9":  # 264 features: W = 9 > GROUP_MAX_WORDS
        extra = both_libs([[rand_seq(rng, 60) for _ in range(264)]], [Config(kmer_length=K)])
        ref_ix, port_ix = ref_ix[:1] + extra[0], port_ix[:1] + extra[1]
        ref_cfg, port_cfg = ref_cfg[:1] + extra[2], port_cfg[:1] + extra[3]
    elif case in ("no-group-entries", "two-g"):
        extra = both_libs([[rand_seq(rng, 200) for _ in range(3)]], [Config(kmer_length=K)],
                          group_g=0 if case == "no-group-entries" else 5)
        ref_ix, port_ix = ref_ix[:1] + extra[0], port_ix[:1] + extra[1]
        ref_cfg, port_cfg = ref_cfg[:1] + extra[2], port_cfg[:1] + extra[3]
    ref = RS.StackedEngine(ref_ix, ref_cfg, chunk_size=32, max_len=max_len)
    eng = TS.StackedEngine(port_ix, port_cfg, CPU, chunk_size=32, max_len=max_len)
    assert eng.group_g == ref.group_g == (ref_ix[0].pair_g if case == "default" else 0)
    assert eng.seg_words == ref.seg_words
    if eng.group_g:
        assert set(eng.tables) == set(ref.tables) == set(TS.STACKED_GROUP_KEYS)
        assert all(np.array_equal(eng.tables[k].numpy(), np.asarray(ref.tables[k])) for k in ref.tables)
    else:
        assert set(eng.tables) == {"mono_bucket", "mono_stash"}


def test_not_stackable_raises():
    """A stack wider than STACK_MAX_WORDS (or one whose tables cannot be
    placed) raises NotStackable, a ValueError as the reference's."""
    wide = types.SimpleNamespace(k=K, n_buckets=1024, bitset_words=40, has_pairs=False)
    assert TS.build_stacked_tables([wide, wide]) is None
    assert TS.build_stacked_group_tables([wide, wide]) is None
    with pytest.raises(TS.NotStackable):
        TS.StackedEngine([wide, wide], [PortConfig(), PortConfig()], CPU, max_len=80)
    assert issubclass(TS.NotStackable, ValueError)


def _write_libs(tmp_path, libs, k=K):
    paths = []
    for name, seqs in libs.items():
        p = tmp_path / f"{name}.json"
        cfg = Config(kmer_length=k)
        p.write_text(json.dumps([cfg.to_dict(), make_data(seqs, names=[f"{name}_{i}" for i in range(len(seqs))])
                                 .__dict__]))
        paths.append(str(p))
    return ",".join(paths)


def _write_reads(path, src, n, ln, seed, short=0):
    """n reads of ln bases from the sources (half reverse-complemented);
    every seventh read cut to `short` bases when short > 0."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            s = src[rng.integers(0, len(src))]
            m = short if short and i % 7 == 0 else min(ln, len(s))
            p0 = int(rng.integers(0, max(1, len(s) - m)))
            read = s[p0 : p0 + m]
            if rng.random() < 0.5:
                read = seqmod.decode(seqmod.revcomp_codes(seqmod.encode(read)))
            f.write(f"@r{i}\n{read}\n+\n{'I' * len(read)}\n")
    return str(path)


def _port_run(tmp_path, monkeypatch, args, tag):
    """One port `align` on the CPU with its own run log; returns its events."""
    log = tmp_path / f"runlog_{tag}.jsonl"
    monkeypatch.setattr(observability, "_GLOBAL", observability.RunLog(str(log)))
    assert port_cli([*args, "--device", "cpu"]) == 0
    monkeypatch.setattr(observability, "_GLOBAL", None)
    return [json.loads(ln) for ln in log.read_text().splitlines()]


def _three_runs(tmp_path, monkeypatch, ref, inputs, names, flags=()):
    """align through the port stacked (NIMBLE_TPU_STACK=1), the port by
    default and the reference CLI (stacked, its default); every library's
    TSV must be the same bytes in all three, and not empty. The default run
    must build one unstacked engine per library. Returns the port's run log
    events of the stacked run."""
    outs = {tag: tmp_path / f"{tag}.tsv" for tag in ("stacked", "separate", "reference")}
    args = ["align", "--reference", ref, "--input", *inputs, *flags]
    monkeypatch.setenv("NIMBLE_TPU_STACK", "1")
    events = _port_run(tmp_path, monkeypatch, [*args, "--output", str(outs["stacked"])], "stacked")
    monkeypatch.delenv("NIMBLE_TPU_STACK")
    assert ref_cli([*args, "--output", str(outs["reference"])]) == 0
    separate = _engine_events(_port_run(tmp_path, monkeypatch, [*args, "--output", str(outs["separate"])],
                                        "separate"))
    assert [e["event"] for e in separate] == ["engine"] * len(names)
    assert not any(e["path"].startswith("stacked") for e in separate)
    for name in names:
        got = {tag: open(append_path_string(str(p), f".{name}"), "rb").read() for tag, p in outs.items()}
        assert got["stacked"] == got["reference"] == got["separate"], name
        assert got["stacked"].count(b"\n") > 1, name
    return events


def _engine_events(events):
    return [e for e in events if e["event"] in ("engine", "stacked_engine")]


PIPELINE_CASES = {
    "group": dict(path="stacked-group"),
    "mono-env": dict(path="stacked-mono", env=True),
    "probe-mono": dict(path="stacked-mono", flags=["--probe", "mono"]),
    "group-short-reads": dict(path="stacked-group", short=16),
    "group-paired": dict(path="stacked-group", paired=True),
    "group-trim": dict(path="stacked-group", flags=["--trim", "60:0.5,60:0.5,60:0.5"]),
    "trims-differ": dict(path="group", flags=["--trim", "60:0.5"]),
}


@pytest.mark.parametrize("case", sorted(PIPELINE_CASES))
def test_align_stacked_tsvs_match(tmp_path, monkeypatch, case):
    """tests/test_stacked.py:182 through the port's CLI on three libraries:
    the NIMBLE_TPU_STACK=1 TSVs == the default (per-library) TSVs == the
    reference CLI's, on the group stack, the mono stack (NIMBLE_TPU_NO_GROUP_PROBE, or
    `--probe mono`), paired, trimmed, and with reads shorter than k+g-1
    (each library's host mono repair on the group stack). The run log's
    `engine` event names the stacked path; libraries of different trims
    run one engine each."""
    c = PIPELINE_CASES[case]
    if c.get("env"):
        monkeypatch.setenv("NIMBLE_TPU_NO_GROUP_PROBE", "1")
    rng = np.random.default_rng(21)
    base = rand_seq(rng, 600)
    libs = {
        "liba": [base[i : i + 200] for i in range(0, 400, 40)],
        "libb": [base[100:300], rand_seq(rng, 300)],
        "libc": [base[50:250] + rand_seq(rng, 50)],
    }
    ref = _write_libs(tmp_path, libs)
    src = [s for seqs in libs.values() for s in seqs]
    inputs = [_write_reads(tmp_path / "r1.fastq", src, 150, 80, 1, c.get("short", 0))]
    if c.get("paired"):
        inputs.append(_write_reads(tmp_path / "r2.fastq", src, 150, 80, 2))
    events = _three_runs(tmp_path, monkeypatch, ref, inputs, libs, c.get("flags", ()))
    eng = _engine_events(events)
    if not c["path"].startswith("stacked"):  # libraries of different trims are not stacked
        assert [(e["event"], e["path"]) for e in eng] == [("engine", c["path"])] * 3
        return
    assert [e["event"] for e in eng] == ["stacked_engine", "engine"]
    assert eng[1]["path"] == c["path"] and eng[1]["n_libraries"] == 3 and eng[1]["wire"] == "full"
    assert eng[0]["group_g"] == (6 if c["path"] == "stacked-group" else 0)
    patched = [e for e in events if e["event"] == "short_read_patch"]
    assert bool(patched) == bool(c.get("short"))


def test_align_stacked_wide_library_matches_separate(tmp_path, monkeypatch):
    """tests/test_stacked.py:230: a library wider than the group gate (W =
    9) next to a narrow one takes the mono stack, and its TSVs equal the
    per-library engines' and the reference's."""
    rng = np.random.default_rng(31)
    libs = {"wide": [rand_seq(rng, 60) for _ in range(T.GROUP_MAX_WORDS * 32 + 8)],
            "narrow": [rand_seq(rng, 200) for _ in range(3)]}
    ref = _write_libs(tmp_path, libs)
    src = libs["wide"][:40] + libs["narrow"]
    events = _three_runs(tmp_path, monkeypatch, ref, [_write_reads(tmp_path / "r.fastq", src, 80, 50, 3)], libs)
    assert _engine_events(events)[1]["path"] == "stacked-mono"


def test_stacked_read_width_rebuild(tmp_path, monkeypatch):
    """Reads longer than the first batch's width rebuild the stacked engine
    wider mid-run (the run log's `max_len_rebuild`, then a second stacked
    engine); every library's TSV equals the reference's align_files (which
    stacks) and the port's per-library run."""
    from nimble_tpu.align.pipeline import align_files as ref_align
    from nimble_tpu_torch.align.pipeline import align_files as port_align

    rng = np.random.default_rng(41)
    base = rand_seq(rng, 600)
    libs = {"liba": [base[i : i + 200] for i in range(0, 400, 80)], "libb": [base[100:400], rand_seq(rng, 300)]}
    ref = _write_libs(tmp_path, libs)
    src = [s for seqs in libs.values() for s in seqs]
    fq = tmp_path / "grow.fastq"
    with open(fq, "w") as f:
        for i, n in enumerate([40] * 16 + [150] * 16 + [90] * 8):
            s = src[rng.integers(0, len(src))]
            st = int(rng.integers(0, len(s) - n + 1))
            f.write(f"@r{i}\n{s[st : st + n]}\n+\n{'I' * n}\n")
    outs = {tag: str(tmp_path / f"{tag}.tsv") for tag in ("ref", "stacked", "separate")}
    assert ref_align(ref, outs["ref"], [str(fq)], batch_records=8) == 0
    log = tmp_path / "runlog.jsonl"
    monkeypatch.setattr(observability, "_GLOBAL", observability.RunLog(str(log)))
    monkeypatch.setenv("NIMBLE_TPU_STACK", "1")
    assert port_align(ref, outs["stacked"], [str(fq)], CPU, batch_records=8) == 0
    monkeypatch.setattr(observability, "_GLOBAL", None)
    monkeypatch.delenv("NIMBLE_TPU_STACK")
    assert port_align(ref, outs["separate"], [str(fq)], CPU, batch_records=8) == 0
    events = [json.loads(ln) for ln in log.read_text().splitlines()]
    kinds = [e["event"] for e in events if e["event"] in ("engine", "max_len_rebuild")]
    assert kinds == ["engine", "max_len_rebuild", "engine"]
    assert all(e["path"] == "stacked-group" for e in _engine_events(events) if e["event"] == "engine")
    for name in libs:
        got = {tag: open(append_path_string(p, f".{name}"), "rb").read() for tag, p in outs.items()}
        assert got["stacked"] == got["ref"] == got["separate"], name
        assert got["stacked"].count(b"\n") > 20, name


def test_wide47_stack_matches_reference(wide47, tmp_path, monkeypatch):
    """A W = 47 library next to a narrow one: the mono stack at W_cat = 48
    (mono_probe's S = 2 branch at a wide concatenated row) equals the
    reference's StackedEngine on pairs; through the CLI (single-end) the
    port's stacked TSVs equal the reference CLI's stacked TSVs, and the
    port's separate TSVs the reference's separate TSVs (and here the
    reference's stacked TSVs equal its separate ones)."""
    (ref_ix, port_ix, ref_cfg, port_cfg), src = wide47
    rng = np.random.default_rng(4)
    src_reads = src[:60] + src[1480:]
    r1, l1 = make_reads(rng, src_reads, 96, 40)
    r2, l2 = make_reads(rng, src_reads, 96, 40)
    ref = RS.StackedEngine(ref_ix, ref_cfg, chunk_size=64, max_len=40, paired=True)
    eng = TS.StackedEngine(port_ix, port_cfg, CPU, chunk_size=64, max_len=40, paired=True)
    assert eng.path == "stacked-mono" and eng.seg_words == (0, 47, 48)
    got = eng.align_batch(r1, l1, r2, l2)
    _assert_outputs_equal(ref.collect_async(ref.align_batch_async(r1, l1, r2, l2)), got, "reference")
    assert got[0]["pass_"].any() and got[1]["pass_"].any()

    libs = {"wide": src[:1480], "narrow": src[1480:]}
    ref = _write_libs(tmp_path, libs)
    fq = _write_reads(tmp_path / "r.fastq", src_reads, 120, 40, 5)
    outs = {}
    for stack in ("1", ""):  # "1": both packages stacked; "": neither
        monkeypatch.setenv("NIMBLE_TPU_STACK", stack)
        monkeypatch.setenv("NIMBLE_TPU_NO_STACK", "" if stack else "1")
        for tag, cli, extra in (("ref", ref_cli, []), ("port", port_cli, ["--device", "cpu"])):
            out = tmp_path / f"{tag}{stack}.tsv"
            assert cli(["align", "--reference", ref, "--input", fq, "--output", str(out), *extra]) == 0
            outs[tag, stack] = [open(append_path_string(str(out), f".{n}"), "rb").read() for n in libs]
    assert outs["port", "1"] == outs["ref", "1"]
    assert outs["port", ""] == outs["ref", ""]
    assert outs["ref", "1"] == outs["ref", ""]  # the reference's own stack changes no byte here
    assert all(t.count(b"\n") > 1 for t in outs["port", "1"])


def _stackscale(n_per_lib: int):
    """scripts/stackscale.py's lib_workload and the read draws of its main()
    (from `rng = ...default_rng(9)` to `lens = ...`), run from the script's
    own source with N_PER_LIB set, as the port's generator raises it.
    Returns (lib_workload, codes)."""
    import ast
    import pathlib

    from nimble_tpu.config import Data

    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "stackscale.py"
    tree = ast.parse(path.read_text())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    body = funcs["main"].body
    first = next(i for i, st in enumerate(body) if "default_rng(9)" in ast.unparse(st))
    last = next(i for i, st in enumerate(body) if ast.unparse(st).startswith("lens ="))
    ns = {"np": np, "seqmod": seqmod, "Data": Data, "N_PER_LIB": n_per_lib, "L_LIBS": 3,
          "B": types.SimpleNamespace(ALLELE_LEN=3000, READ_LEN=100)}
    exec(compile(ast.Module(body=[funcs["lib_workload"]], type_ignores=[]), str(path), "exec"), ns)
    ns["all_alleles"] = [ns["lib_workload"](s)[1] for s in range(3)]
    exec(compile(ast.Module(body=body[first:last], type_ignores=[]), str(path), "exec"), ns)
    return ns["lib_workload"], ns["codes"]


def test_write_stacked_is_stackscales_workload(tmp_path):
    """bench_data.write_stacked writes scripts/stackscale.py's libraries
    (with 100 alleles each) and the first reads of its draws."""
    import gzip

    from nimble_tpu_torch import bench_data

    lib_workload, codes = _stackscale(bench_data.N_ALLELES)
    n = codes.shape[0]  # its error draws depend on the read count
    libs, fq, pairs = bench_data.write_stacked(tmp_path, n)
    assert pairs is None and len(libs) == 3
    for seed, lib in enumerate(libs):
        config, data = json.load(open(lib))
        assert config == Config().to_dict()
        want, _ = lib_workload(seed)
        assert data["columns"] == want.columns and data["headers"] == want.headers
    with gzip.open(fq, "rt") as f:
        reads = [ln.strip() for i, ln in enumerate(f) if i % 4 == 1]
    assert reads == [seqmod.decode(c) for c in codes]


def test_stacked_workload_through_the_cli(tmp_path, monkeypatch):
    """The stacked workload end to end, small (4 alleles a library; at 100
    the merged group table alone takes 3.9 GB): 10x-shaped pairs
    (fastq-to-bam) over the three libraries through the port stacked, the
    port per library and the reference CLI, TSVs byte for byte; then each
    library's report equals the reference's."""
    from nimble_tpu_torch import bench_data

    libs, _, (r1, r2, wl) = bench_data.write_stacked(tmp_path, 0, 300, alleles=4)
    bam = str(tmp_path / "tagged.bam")
    assert port_cli(["fastq-to-bam", "--r1-fastq", r1, "--r2-fastq", r2, "--map", wl, "--output", bam]) == 0
    names = [f"stacked{i}" for i in range(3)]
    events = _three_runs(tmp_path, monkeypatch, ",".join(libs), [bam], names)
    assert _engine_events(events)[1]["path"] == "stacked-group"
    for name in names:
        tsv = append_path_string(str(tmp_path / "stacked.tsv"), f".{name}")
        outs = [str(tmp_path / f"{name}.{tag}.counts") for tag in ("ref", "port")]
        assert ref_cli(["report", "-i", tsv, "-o", outs[0]]) == 0
        assert port_cli(["report", "-i", tsv, "-o", outs[1]]) == 0
        a, b = (open(o, "rb").read() for o in outs)
        assert a == b and a.count(b"\n") > 1, name
