"""Several libraries in one `align`, on the CPU: the port runs one
AlignEngine per library, where the reference (nimble_tpu/align/stacked.py)
stacks them into one merged probe. Each library's outputs, key for key,
equal the reference's StackedEngine split by library, on its group and its
mono stack and at its gates, wherever the stack takes that library's own
probe; where it does not, they differ on exactly the reads whose windows
the group probe loses to a read error. The `align` TSVs of the port equal the
reference CLI's byte for byte (single-end, paired, `--probe mono`, trims,
short reads, a wide library, a read-width rebuild, 10x pairs and their
report). Modelled on tests/test_stacked.py."""
import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from nimble_tpu import seq as seqmod
from nimble_tpu.__main__ import main as ref_cli
from nimble_tpu.align import engine as RE
from nimble_tpu.align import stacked as RS
from nimble_tpu.config import Config
from nimble_tpu_torch import observability
from nimble_tpu_torch.__main__ import main as port_cli
from nimble_tpu_torch.align import engine as T
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


def _per_library_matches_stack(ref_ix, port_ix, ref_cfg, port_cfg, r1, l1, r2=None, l2=None, **kw):
    """The reference's StackedEngine and one port AlignEngine per library,
    built with the same arguments, on the same reads: every library's
    outputs equal, every key. Returns (the reference's engine, the port's
    engines, the port's outputs)."""
    ref = RS.StackedEngine(ref_ix, ref_cfg, **kw)
    engines = [T.AlignEngine(ix, cfg, CPU, **kw) for ix, cfg in zip(port_ix, port_cfg)]
    got = [e.align_batch(r1, l1, r2, l2) for e in engines]
    _assert_outputs_equal(ref.collect_async(ref.align_batch_async(r1, l1, r2, l2)), got, "reference")
    return ref, engines, got


@pytest.mark.parametrize("which", ["shared", "wide47"])
def test_stacked_tables_equal_reference(wide47, monkeypatch, which):
    """On the library sets that the engine cases on three libraries do not
    cover: k-mers shared across two libraries (one library's only feature is
    the other's first), and a W = 47 library beside a narrow one (a 48-word
    stack, which the reference takes on its mono stack). Each port engine's
    rows equal that library's rows of the reference's stack. The W = 47
    engine runs off the group probe (monocls), whose wire is dense bits:
    on its default gband path the wire is feature ids, which the CLI
    comparisons of this library hold to the reference."""
    if which == "wide47":
        monkeypatch.setenv("NIMBLE_TPU_NO_GROUP_PROBE", "1")
        (ref_ix, port_ix, ref_cfg, port_cfg), src = wide47
        src = src[:60] + src[1480:]
        want_g, L = 0, 40
    else:
        rng = np.random.default_rng(5)
        shared = rand_seq(rng, 100)
        src = [shared, rand_seq(rng, 80)]
        ref_ix, port_ix, ref_cfg, port_cfg = both_libs([[shared], src], [Config(), Config()])
        want_g, L = ref_ix[0].pair_g, 60
    r1, l1, _, _ = _reads(src, False, seed=7, n=96, L=L)
    ref, _, got = _per_library_matches_stack(ref_ix, port_ix, ref_cfg, port_cfg, r1, l1, chunk_size=32,
                                             max_len=L)
    assert ref.group_g == want_g and all(o["pass_"].any() for o in got)


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
    """Each library's own port AlignEngine == that library's outputs of the
    reference's StackedEngine, every output key, exactly
    (tests/test_stacked.py:70). The reference takes its mono stack, and the
    port's engines the mono path, with NIMBLE_TPU_NO_GROUP_PROBE=1 or
    kmer_stride = 2; else the group stack and the group path."""
    c = ENGINE_CASES[case]
    ref_ix, port_ix, ref_cfg, port_cfg, src = libs3
    if c.get("mono"):
        monkeypatch.setenv("NIMBLE_TPU_NO_GROUP_PROBE", "1")
    if c.get("stride"):
        ref_cfg = [dataclasses.replace(x, kmer_stride=c["stride"]) for x in ref_cfg]
        port_cfg = [dataclasses.replace(x, kmer_stride=c["stride"]) for x in port_cfg]
    paired, strand = c["paired"], c.get("strand", "unstranded")
    r1, l1, r2, l2 = _reads(src, paired, seed=len(case))
    mono = c.get("mono") or c.get("stride")
    ref, engines, got = _per_library_matches_stack(ref_ix, port_ix, ref_cfg, port_cfg, r1, l1, r2, l2,
                                                   strand_filter=strand, chunk_size=32, max_len=80, paired=paired)
    assert bool(ref.group_g) == (not mono)
    assert [e.path for e in engines] == ["mono" if mono else "group"] * 3
    assert any(o["pass_"].any() for o in got)


GATE_CASES = ["default", "max-len-short", "no-group-env", "stride2", "wide-w9", "no-group-entries",
              "two-g"]


def _lost_window_reads(codes, lens, seqs, k: int, g: int, L: int) -> set:
    """The reads on which the group probe of a library of these sequences
    answers fewer windows than the mono probe (nimble_tpu/align/engine.py:
    _score_mate_group): a k-window of the read that occurs in the library
    (either strand) which no probe answers, a probe being a (k+g-1)-mer of
    the read, at a multiple of g or at the tail len-(k+g-1), that occurs in
    the library and covers windows probe..probe+g-1. A read error or N
    inside every probe around such a window loses it."""
    kg = k + g - 1
    kmers, kgmers = set(), set()
    for s in seqs:
        for t in (s, seqmod.decode(seqmod.revcomp_codes(seqmod.encode(s)))):
            kmers.update(t[i : i + k] for i in range(len(t) - k + 1))
            kgmers.update(t[i : i + kg] for i in range(len(t) - kg + 1))
    PP = L - kg + 1
    lost = set()
    for r, n in enumerate(int(x) for x in lens):
        read = seqmod.decode(codes[r, :n])
        probes = [p for p in [*range(0, PP, g), min(max(n - kg, 0), PP - 1)]
                  if p + kg <= n and read[p : p + kg] in kgmers]
        if any(read[j : j + k] in kmers and not any(p <= j < p + g for p in probes) for j in range(n - k + 1)):
            lost.add(r)
    return lost


@pytest.mark.parametrize("case", GATE_CASES)
def test_group_gate_matches_reference(libs3, monkeypatch, case):
    """At each of the reference stack's gates (stacked.py:468-479: every
    library with group entries of one g, at W <= GROUP_MAX_WORDS and stride
    1, reads at least k+g-1 long and NIMBLE_TPU_NO_GROUP_PROBE unset; else
    its mono stack) each port engine takes its own library's path, and its
    rows equal those of the reference's engine of that library alone (what
    the reference runs under NIMBLE_TPU_NO_STACK=1). Where the port's
    engine takes the probe the stack took for every library, its rows also
    equal that library's rows of the reference's stack. Where the stack's
    gate sends a library that takes the group probe alone to the mono stack
    (a set with a W = 9 library, one without group entries, or two g), the
    stack's rows of it are that library's mono path, exactly; they differ
    from the group rows alone on exactly the reads whose windows the group
    probe loses to a read error (_lost_window_reads), and there the group
    scores are never higher (ROADMAP, faults found in the reference)."""
    ref_ix, port_ix, ref_cfg, port_cfg, src = libs3
    max_len = L = 80
    rng = np.random.default_rng(9)
    lib_seqs = [src[:10]]
    if case == "max-len-short":
        max_len = L = K + ref_ix[0].pair_g - 2
    elif case == "no-group-env":
        monkeypatch.setenv("NIMBLE_TPU_NO_GROUP_PROBE", "1")
    elif case == "stride2":
        ref_cfg = [dataclasses.replace(x, kmer_stride=2) for x in ref_cfg]
        port_cfg = [dataclasses.replace(x, kmer_stride=2) for x in port_cfg]
    elif case in ("wide-w9", "no-group-entries", "two-g"):
        if case == "wide-w9":  # 264 features: W = 9 > GROUP_MAX_WORDS
            seqs, kw, L = [rand_seq(rng, 60) for _ in range(264)], {}, 60
        else:
            seqs, kw = [rand_seq(rng, 200) for _ in range(3)], {"group_g": 0 if case == "no-group-entries" else 5}
        extra = both_libs([seqs], [Config(kmer_length=K)], **kw)
        ref_ix, port_ix = ref_ix[:1] + extra[0], port_ix[:1] + extra[1]
        ref_cfg, port_cfg = ref_cfg[:1] + extra[2], port_cfg[:1] + extra[3]
        src = src[:10] + seqs[:10]
        lib_seqs.append(seqs)
    r1, l1, _, _ = _reads(src, False, seed=len(case), L=L)
    kw = dict(chunk_size=32, max_len=max_len)
    ref = RS.StackedEngine(ref_ix, ref_cfg, **kw)
    assert ref.group_g == (ref_ix[0].pair_g if case == "default" else 0)
    stacked = ref.collect_async(ref.align_batch_async(r1, l1))
    engines = [T.AlignEngine(ix, cfg, CPU, **kw) for ix, cfg in zip(port_ix, port_cfg)]
    got = [e.align_batch(r1, l1) for e in engines]
    alone = [RE.AlignEngine(ix, cfg, **kw) for ix, cfg in zip(ref_ix, ref_cfg)]
    _assert_outputs_equal([e.collect_async(e.align_batch_async(r1, l1)) for e in alone], got, "reference alone")
    group_alone = case in ("default", "wide-w9", "no-group-entries", "two-g")
    assert engines[0].path == ("group" if group_alone else "mono")
    same_probe = [li for li, e in enumerate(engines) if bool(e.params.group_g) == bool(ref.group_g)]
    assert same_probe == ([1] if group_alone and not ref.group_g and case != "two-g" else
                          [] if case == "two-g" else [0, 1, 2])
    _assert_outputs_equal([stacked[li] for li in same_probe], [got[li] for li in same_probe], "reference stacked")
    assert any(o["r1_fwd"].any() and o["r1_rev"].any() for o in got)  # windows matched both ways
    for li in sorted(set(range(len(engines))) - set(same_probe)):
        assert engines[li].path == "group" and not ref.group_g
        with monkeypatch.context() as m:
            m.setenv("NIMBLE_TPU_NO_GROUP_PROBE", "1")
            mono = T.AlignEngine(port_ix[li], port_cfg[li], CPU, **kw)
            assert mono.path == "mono"
            _assert_outputs_equal([stacked[li]], [mono.align_batch(r1, l1)], "reference stacked, mono path")
        differ = set()
        for key, want in stacked[li].items():
            rows = (np.asarray(want) != got[li][key]).reshape(len(l1), -1).any(axis=1)
            differ.update(np.flatnonzero(rows).tolist())
        lost = _lost_window_reads(r1, l1, lib_seqs[li], K, port_ix[li].pair_g, max_len)
        assert differ == lost and lost, f"library {li}"
        for key in ("r1_fwd", "r1_rev"):
            assert (got[li][key] <= np.asarray(stacked[li][key])).all(), f"library {li}, {key}"


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


def _two_runs(tmp_path, monkeypatch, ref, inputs, names, flags=()):
    """align through the port (one engine per library) and the reference
    CLI (stacked, its default); every library's TSV must be the same bytes
    in both, and not empty. Returns the port's run log events, whose
    `engine` events must be one per library."""
    outs = {tag: tmp_path / f"{tag}.tsv" for tag in ("port", "reference")}
    args = ["align", "--reference", ref, "--input", *inputs, *flags]
    assert ref_cli([*args, "--output", str(outs["reference"])]) == 0
    events = _port_run(tmp_path, monkeypatch, [*args, "--output", str(outs["port"])], "port")
    assert len(_engine_events(events)) == len(names)
    for name in names:
        got = {tag: open(append_path_string(str(p), f".{name}"), "rb").read() for tag, p in outs.items()}
        assert got["port"] == got["reference"], name
        assert got["port"].count(b"\n") > 1, name
    return events


def _engine_events(events):
    return [e for e in events if e["event"] == "engine"]


PIPELINE_CASES = {
    "group": dict(path="group"),
    "mono-env": dict(path="mono", env=True),
    "probe-mono": dict(path="mono", flags=["--probe", "mono"]),
    "group-short-reads": dict(path="group", short=16),
    "group-paired": dict(path="group", paired=True),
    "group-trim": dict(path="group", flags=["--trim", "60:0.5,60:0.5,60:0.5"]),
    "trims-differ": dict(path="group", flags=["--trim", "60:0.5"]),
}


@pytest.mark.parametrize("case", sorted(PIPELINE_CASES))
def test_align_stacked_tsvs_match(tmp_path, monkeypatch, case):
    """tests/test_stacked.py:182 through the port's CLI on three libraries:
    the port's TSVs == the reference CLI's (which stacks libraries of one
    trim), on the group path, the mono path (NIMBLE_TPU_NO_GROUP_PROBE, or
    `--probe mono`), paired, trimmed alike and not, and with reads shorter
    than k+g-1 (each library's host mono repair on the group path). The run
    log's `engine` events name each library's path and the full wire."""
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
    events = _two_runs(tmp_path, monkeypatch, ref, inputs, libs, c.get("flags", ()))
    assert [(e["path"], e["wire"]) for e in _engine_events(events)] == [(c["path"], "full")] * 3
    patched = [e for e in events if e["event"] == "short_read_patch"]
    assert bool(patched) == bool(c.get("short"))


def test_align_stacked_wide_library_matches_separate(tmp_path, monkeypatch):
    """tests/test_stacked.py:230: a library wider than the group gate (W =
    9) next to a narrow one, which the reference takes on its mono stack:
    the port's engines take the mono path and the group path, and every
    TSV equals the reference's."""
    rng = np.random.default_rng(31)
    libs = {"wide": [rand_seq(rng, 60) for _ in range(T.GROUP_MAX_WORDS * 32 + 8)],
            "narrow": [rand_seq(rng, 200) for _ in range(3)]}
    ref = _write_libs(tmp_path, libs)
    src = libs["wide"][:40] + libs["narrow"]
    events = _two_runs(tmp_path, monkeypatch, ref, [_write_reads(tmp_path / "r.fastq", src, 80, 50, 3)], libs)
    assert [e["path"] for e in _engine_events(events)] == ["mono", "group"]


def test_stacked_read_width_rebuild(tmp_path, monkeypatch):
    """Reads longer than the first batch's width rebuild every library's
    engine wider mid-run (the run log's `max_len_rebuild`, then one engine
    per library again); every library's TSV equals the reference's
    align_files (which stacks)."""
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
    outs = {tag: str(tmp_path / f"{tag}.tsv") for tag in ("ref", "port")}
    assert ref_align(ref, outs["ref"], [str(fq)], batch_records=8) == 0
    log = tmp_path / "runlog.jsonl"
    monkeypatch.setattr(observability, "_GLOBAL", observability.RunLog(str(log)))
    assert port_align(ref, outs["port"], [str(fq)], CPU, batch_records=8) == 0
    monkeypatch.setattr(observability, "_GLOBAL", None)
    events = [json.loads(ln) for ln in log.read_text().splitlines()]
    kinds = [e["event"] for e in events if e["event"] in ("engine", "max_len_rebuild")]
    assert kinds == ["engine", "engine", "max_len_rebuild", "engine", "engine"]
    assert all(e["path"] == "group" for e in _engine_events(events))
    for name in libs:
        got = {tag: open(append_path_string(p, f".{name}"), "rb").read() for tag, p in outs.items()}
        assert got["port"] == got["ref"], name
        assert got["port"].count(b"\n") > 20, name


def test_wide47_stack_matches_reference(wide47, tmp_path, monkeypatch):
    """A W = 47 library next to a narrow one, which the reference takes on
    its mono stack at W_cat = 48: the port's engine of each library equals
    that library's rows of the reference's StackedEngine on pairs; through
    the CLI (single-end) the port's TSVs equal the reference CLI's, stacked
    and not (NIMBLE_TPU_NO_STACK=1, which the port does not read). The
    engines run off the group probe, so the wide one ships dense bits
    (monocls); the CLI runs take the default paths, gband for the wide
    library."""
    (ref_ix, port_ix, ref_cfg, port_cfg), src = wide47
    rng = np.random.default_rng(4)
    src_reads = src[:60] + src[1480:]
    r1, l1 = make_reads(rng, src_reads, 96, 40)
    r2, l2 = make_reads(rng, src_reads, 96, 40)
    with monkeypatch.context() as m:
        m.setenv("NIMBLE_TPU_NO_GROUP_PROBE", "1")
        ref, engines, got = _per_library_matches_stack(ref_ix, port_ix, ref_cfg, port_cfg, r1, l1, r2, l2,
                                                       chunk_size=64, max_len=40, paired=True)
    assert ref.group_g == 0 and ref.seg_words == (0, 47, 48) and engines[0].wire == "full"
    assert got[0]["pass_"].any() and got[1]["pass_"].any()

    libs = {"wide": src[:1480], "narrow": src[1480:]}
    ref = _write_libs(tmp_path, libs)
    fq = _write_reads(tmp_path / "r.fastq", src_reads, 120, 40, 5)
    outs = {}
    for no_stack in ("", "1"):
        monkeypatch.setenv("NIMBLE_TPU_NO_STACK", no_stack)
        for tag, cli, extra in (("ref", ref_cli, []), ("port", port_cli, ["--device", "cpu"])):
            out = tmp_path / f"{tag}{no_stack}.tsv"
            assert cli(["align", "--reference", ref, "--input", fq, "--output", str(out), *extra]) == 0
            outs[tag, no_stack] = [open(append_path_string(str(out), f".{n}"), "rb").read() for n in libs]
    assert outs["port", ""] == outs["ref", ""] == outs["ref", "1"] == outs["port", "1"]
    assert all(t.count(b"\n") > 1 for t in outs["port", ""])


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
    """The stacked workload end to end, small (4 alleles a library):
    10x-shaped pairs (fastq-to-bam) over the three libraries through the
    port, one engine each on the group path, and the reference CLI
    (stacked), TSVs byte for byte; then each library's report equals the
    reference's."""
    from nimble_tpu_torch import bench_data

    libs, _, (r1, r2, wl) = bench_data.write_stacked(tmp_path, 0, 300, alleles=4)
    bam = str(tmp_path / "tagged.bam")
    assert port_cli(["fastq-to-bam", "--r1-fastq", r1, "--r2-fastq", r2, "--map", wl, "--output", bam]) == 0
    names = [f"stacked{i}" for i in range(3)]
    events = _two_runs(tmp_path, monkeypatch, ",".join(libs), [bam], names)
    assert [e["path"] for e in _engine_events(events)] == ["group"] * 3
    for name in names:
        tsv = append_path_string(str(tmp_path / "port.tsv"), f".{name}")
        outs = [str(tmp_path / f"{name}.{tag}.counts") for tag in ("ref", "port")]
        assert ref_cli(["report", "-i", tsv, "-o", outs[0]]) == 0
        assert port_cli(["report", "-i", tsv, "-o", outs[1]]) == 0
        a, b = (open(o, "rb").read() for o in outs)
        assert a == b and a.count(b"\n") > 1, name
