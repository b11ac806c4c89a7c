"""The port's threaded FASTQ reader (nimble_tpu_torch/io/threaded.py) on
every path its input can call for, against a one-pass serial zlib parse.

The serial reference inflates the whole file in one pass (zlib, member
after member, as far as the bytes decode), cuts it every 4*batch newlines
and parses each piece. The reader must give the same batches, byte for
byte: on multi-member gz files whose members do not line up with the
batches (libdeflate and zlib inflating), with empty members, a stored
member that holds a false member header, a member too large for the
window, a one-member file with a false header in its data, on
single-member gz and plain files and on streamed chunks that split
batches, paired files of different layouts, under set_skip, and on
truncated files and trailing garbage, which yield and raise as the stream
path does. The run log's `reader` event names the path taken, inflated
bytes held at once stay within the window, and the inflate and parse pools
share the reader's threads. `align` gives the same TSV on the same reads as
multi-member gz, single-member gz and plain FASTQ.
"""
import gzip
import json
import pathlib
import re
import shutil
import tracemalloc
import zlib

import numpy as np
import pytest

from nimble_tpu_torch import observability as obs
from nimble_tpu_torch.__main__ import main as port_cli
from nimble_tpu_torch.io import threaded
from nimble_tpu_torch.io.threaded import ThreadedFastqReader
from tests.test_torch_host_parity import GOLD, native_in_both
from tests.test_torch_resume import SPAN, port_in_process, run_proc, ws  # noqa: F401  (ws: the fixture)

MAX_LEN = 128
KEYS = ("r1_codes", "r1_lens", "names", "r1_seqs", "r1_quals", "r2_codes", "r2_lens", "r2_seqs", "r2_quals")


@pytest.fixture(scope="module", autouse=True)
def native():
    if not native_in_both():
        pytest.skip("native library not built")


def fastq_text(n, seed, first=0):
    """n FASTQ records, 40-120 bases of ACGTN, named from `first`."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(first, first + n):
        L = int(rng.integers(40, 121))
        seq = bytes(b"ACGTN"[j] for j in rng.integers(0, 5, size=L))
        qual = bytes(33 + int(q) for q in rng.integers(0, 40, size=L))
        out.append(b"@read%d desc\n%s\n+\n%s\n" % (i, seq, qual))
    return out


def members(records, per_member, level=1):
    """The records as concatenated gzip members of per_member records."""
    return b"".join(gzip.compress(b"".join(records[i:i + per_member]), compresslevel=level, mtime=0)
                    for i in range(0, len(records), per_member))


def write(path, data):
    path.write_bytes(data)
    return str(path)


def serial_batches(path, batch, with_strings=True):
    """The one-pass serial zlib parse: inflate the file member after member
    as far as its bytes decode (a bad header raises zlib.error), cut the
    output every 4*batch newlines, parse each piece."""
    data = pathlib.Path(path).read_bytes()
    if path.endswith(".gz"):
        out = []
        while data:
            d = zlib.decompressobj(wbits=31)
            out.append(d.decompress(data))
            out.append(d.flush())
            data = d.unused_data if d.eof else b""
        data = b"".join(out)
    arr = np.frombuffer(data, np.uint8)
    nls = np.flatnonzero(arr == 10)
    cuts = [0] + [int(c) + 1 for c in nls[4 * batch - 1::4 * batch]]
    pieces = [(data[a:b], batch) for a, b in zip(cuts, cuts[1:])]
    if data[cuts[-1]:].strip():
        pieces.append((data[cuts[-1]:], -1))
    return [threaded._parse_buffer(p, n, MAX_LEN, with_strings) for p, n in pieces]


def as_batches(parsed, mate="r1"):
    return [{f"{mate}_codes": b["codes"], f"{mate}_lens": b["lens"], f"{mate}_seqs": b.get("seqs"),
             f"{mate}_quals": b.get("quals"), **({"names": b.get("names")} if mate == "r1" else {})}
            for b in parsed]


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in KEYS:
            if k in w and w[k] is not None:
                if isinstance(w[k], np.ndarray):
                    assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
                else:
                    assert list(g[k]) == list(w[k]), k


def read_all(r1, r2=None, batch=768, threads=4, with_strings=True, skip=None):
    reader = ThreadedFastqReader(r1, r2, batch_size=batch, max_len=MAX_LEN, num_threads=threads,
                                 with_strings=with_strings)
    if skip is not None:
        reader.set_skip(skip)
    return list(reader)


@pytest.fixture
def events(tmp_path, monkeypatch):
    """The run log's `reader` events of what the test reads."""
    log = tmp_path / "run.jsonl"
    monkeypatch.setattr(obs, "_GLOBAL", obs.RunLog(str(log)))

    def read():
        if not log.exists():
            return []
        return [e for e in map(json.loads, log.read_text().splitlines()) if e["event"] == "reader"]

    yield read
    obs._GLOBAL.close()
    monkeypatch.setattr(obs, "_GLOBAL", None)


@pytest.fixture(params=["libdeflate", "zlib"])
def inflater(request, monkeypatch):
    if request.param == "libdeflate":
        if threaded._libdeflate() is None:
            pytest.skip("libdeflate is not installed")
    else:
        monkeypatch.setattr(threaded, "_libdeflate", lambda: None)
    return request.param


@pytest.mark.parametrize("per_member,batch,threads", [(1000, 768, 4), (97, 768, 2), (3000, 1000, 3),
                                                      (1, 5, 2)])
def test_members_match_the_serial_parse(tmp_path, events, inflater, per_member, batch, threads):
    n = 40 if per_member == 1 else 6001
    recs = fastq_text(n, seed=per_member)
    path = write(tmp_path / "r.fastq.gz", members(recs, per_member))
    got = read_all(path, batch=batch, threads=threads)
    assert_same(got, as_batches(serial_batches(path, batch)))
    assert sum(b["r1_codes"].shape[0] for b in got) == n
    (ev,) = events()
    assert ev["path"] == "members" and ev["members"] == -(-n // per_member)
    assert ev["merges"] == 0 and ev["fallback"] is False
    assert ev["workers"] == threaded._inflate_workers(threads)


def test_empty_members(tmp_path, events, inflater):
    recs = fastq_text(2500, seed=3)
    data = gzip.compress(b"") + members(recs[:1200], 400) + gzip.compress(b"") + gzip.compress(b"") \
        + members(recs[1200:], 650) + gzip.compress(b"")
    path = write(tmp_path / "r.fastq.gz", data)
    assert_same(read_all(path), as_batches(serial_batches(path, 768)))
    (ev,) = events()
    assert (ev["path"], ev["members"], ev["merges"], ev["fallback"]) == ("members", 4 + 3 + 2, 0, False)


def stored_member(isize=b"\x04\x03\x02\x01", seed=5):
    """A stored (level 0) gzip member of 300 records, one of whose names
    holds a member header behind `isize` (0x01020304 bytes out, plausible
    for the span before it), 20-60 KB in."""
    head = fastq_text(150, seed=seed)
    fake = b"@fake" + isize + b"\x1f\x8b\x08\x01name\nACGT\n+\nIIII\n"
    tail = fastq_text(150, seed=seed + 1, first=151)
    stored = zlib.compressobj(0, zlib.DEFLATED, 31)
    member = stored.compress(b"".join(head) + fake + b"".join(tail)) + stored.flush()
    assert 20_000 < member.index(b"\x1f\x8b\x08\x01") < 60_000
    return member


def test_a_false_header_inside_a_stored_member_is_merged(tmp_path, events, inflater):
    # the span up to the false header is inflated on the pool and fails; the
    # member is streamed to its true end, merging the two spans, and the
    # pool goes on with the members after it
    recs = fastq_text(2000, seed=7, first=400)
    path = write(tmp_path / "r.fastq.gz", members(recs[:700], 350) + stored_member() + members(recs[700:], 500))
    got = read_all(path, batch=256)
    assert_same(got, as_batches(serial_batches(path, 256)))
    (ev,) = events()
    assert (ev["path"], ev["members"], ev["merges"], ev["fallback"]) == ("members", 2 + 1 + 3, 1, True)


@pytest.mark.parametrize("isize", [b"\x04\x03\x02\x01", b"\xff\xff\xff\xff"])
def test_one_member_with_a_false_header_streams(tmp_path, events, inflater, monkeypatch, isize):
    # a plausible false start costs failed inflates of the spans it cuts
    # (never one of the whole file), an implausible one none; either way
    # the file streams from its start as on the stream path, in chunks
    # that split batches
    monkeypatch.setattr(threaded, "_CHUNK_BYTES", 10_007)
    inflated = []
    real = threaded._inflate_members
    monkeypatch.setattr(threaded, "_inflate_members", lambda *a: inflated.append(a[1]) or real(*a))
    path = write(tmp_path / "r.fastq.gz", stored_member(isize))
    assert_same(read_all(path, batch=64), as_batches(serial_batches(path, 64)))
    (ev,) = events()
    assert (ev["path"], ev["members"], ev["merges"], ev["fallback"]) == ("stream", 1, 1, True)
    spans = [(s, e) for task in inflated for s, e, _, _ in task]
    if isize == b"\xff\xff\xff\xff":
        assert spans == []
    else:
        assert spans and all(s > 0 or e < pathlib.Path(path).stat().st_size for s, e in spans)


def test_a_member_past_the_window_streams_the_rest(tmp_path, events, monkeypatch):
    # the big member streams; the pool takes the members after it
    recs = fastq_text(4000, seed=8)
    big = gzip.compress(b"".join(recs[1000:3000]), 1)
    path = write(tmp_path / "r.fastq.gz", members(recs[:1000], 250) + big + members(recs[3000:], 250))
    monkeypatch.setattr(threaded, "_WINDOW_BYTES", 200_000)  # the big member's output is ~370 KB
    monkeypatch.setattr(threaded, "_TASK_BYTES", 30_000)
    monkeypatch.setattr(threaded, "_CHUNK_BYTES", 50_000)
    assert_same(read_all(path, batch=300), as_batches(serial_batches(path, 300)))
    (ev,) = events()
    assert (ev["path"], ev["members"], ev["merges"], ev["fallback"]) == ("members", 4 + 1 + 4, 0, True)


def test_one_member_takes_the_stream_path(tmp_path, events, monkeypatch):
    recs = fastq_text(3000, seed=9)
    path = write(tmp_path / "r.fastq.gz", gzip.compress(b"".join(recs), 6))
    want = as_batches(serial_batches(path, 768))
    assert_same(read_all(path), want)
    monkeypatch.setenv("NIMBLE_TPU_WHOLE_INFLATE", "1")
    assert_same(read_all(path), want)
    plain = write(tmp_path / "r.fastq", b"".join(recs))
    assert_same(read_all(plain), want)
    got = [(e["path"], e["members"], e["fallback"]) for e in events()]
    whole = "whole" if threaded._libdeflate() is not None else "stream"
    assert got == [("stream", 1, False), (whole, 1, False), ("plain", 0, False)]


@pytest.mark.parametrize("chunk", [4099, 65_536])
def test_streamed_chunks_cut_as_one_buffer(tmp_path, monkeypatch, chunk):
    # the stream path and a plain file past the map's cap hand the cutter
    # chunks of the file that split records and batches
    recs = fastq_text(3000, seed=16)
    want = as_batches(serial_batches(write(tmp_path / "r.fastq", b"".join(recs)), 500))
    monkeypatch.setattr(threaded, "_CHUNK_BYTES", chunk)
    monkeypatch.setattr(threaded, "_PLAIN_MMAP_MAX_MB", 0)
    assert_same(read_all(str(tmp_path / "r.fastq"), batch=500), want)
    assert_same(read_all(write(tmp_path / "r.fastq.gz", gzip.compress(b"".join(recs), 1)), batch=500), want)
    assert_same(read_all(write(tmp_path / "r.fastq.gz", members(recs, 1000)), batch=500), want)


def test_the_pools_share_the_threads(tmp_path, monkeypatch):
    made = []
    real = threaded.ThreadPoolExecutor

    def pool(max_workers, thread_name_prefix):
        made.append((thread_name_prefix, max_workers))
        return real(max_workers, thread_name_prefix=thread_name_prefix)

    monkeypatch.setattr(threaded, "ThreadPoolExecutor", pool)
    recs = fastq_text(2000, seed=17)
    multi = write(tmp_path / "multi.fastq.gz", members(recs, 300))
    one = write(tmp_path / "one.fastq.gz", gzip.compress(b"".join(recs), 1))
    for threads in (2, 3, 8, 12):
        w = threaded._inflate_workers(threads)
        assert 1 <= w < threads
        for r1, r2, pools in ((multi, None, {"nimble-parse": threads - w, "nimble-inflate": w}),
                              (one, multi, {"nimble-parse": threads - w, "nimble-inflate": w}),
                              (one, None, {"nimble-parse": threads})):
            made.clear()
            read_all(r1, r2, threads=threads)
            assert dict(made) == pools


def test_paired_files_of_different_layouts(tmp_path, events):
    r1 = fastq_text(5000, seed=10)
    r2 = fastq_text(5000, seed=11)
    p1 = write(tmp_path / "r1.fastq.gz", members(r1, 1000))
    p2 = write(tmp_path / "r2.fastq.gz", members(r2, 333))
    want = as_batches(serial_batches(p1, 700))
    for w, b in zip(want, as_batches(serial_batches(p2, 700), "r2")):
        w.update(b)
    assert_same(read_all(p1, p2, batch=700), want)
    single = write(tmp_path / "r2.single.fastq.gz", gzip.compress(b"".join(r2)))
    assert_same(read_all(p1, single, batch=700), want)
    assert [(e["path"], e["members"]) for e in events()] == [  # a member path's event comes at its end
        ("members", 5), ("members", 16), ("stream", 1), ("members", 5)]
    short = write(tmp_path / "r2.short.fastq.gz", members(r2[:4000], 333))
    with pytest.raises(ValueError, match="different record counts"):
        read_all(p1, short, batch=700)


def test_set_skip_cuts_but_never_parses(tmp_path, monkeypatch):
    recs = fastq_text(5000, seed=12)
    path = write(tmp_path / "r.fastq.gz", members(recs, 900))
    parsed = []
    real = threaded._parse_counted
    monkeypatch.setattr(threaded, "_parse_counted", lambda buf, n, *a: parsed.append(n) or real(buf, n, *a))
    got = read_all(path, batch=500, skip=lambda r0, r1: (r0 // 500) % 3 == 1)
    want = as_batches(serial_batches(path, 500))
    assert [b.get("skip") for b in got] == [500 if i % 3 == 1 else None for i in range(len(want))]
    assert_same([b for b in got if "skip" not in b], [w for i, w in enumerate(want) if i % 3 != 1])
    assert len(parsed) == len(want) - len(want) // 3


@pytest.mark.parametrize("cut", [100, 5000, 31_000])
def test_a_truncated_file_reads_as_on_the_stream_path(tmp_path, events, inflater, cut):
    # the stream path raises nothing here: it yields the records the bytes
    # hold, the last one cut short; the member path streams its last member
    recs = fastq_text(3000, seed=13)
    data = members(recs, 700)
    path = write(tmp_path / "r.fastq.gz", data[:-cut])
    got = read_all(path)
    assert_same(got, as_batches(serial_batches(path, 768)))
    one = write(tmp_path / "one.fastq.gz", gzip.compress(b"".join(recs), 1)[:-cut])
    assert_same(read_all(one), as_batches(serial_batches(one, 768)))
    ev = events()[0]
    assert (ev["path"], ev["fallback"]) == ("members", True) and ev["members"] < 5


@pytest.mark.parametrize("garbage", [b"garbage!" * 4, b"\0" * 100, b"\x1f\x8b\x08\x00" + b"\0" * 30])
def test_trailing_garbage_raises_as_on_the_stream_path(tmp_path, events, inflater, garbage):
    recs = fastq_text(2000, seed=14)
    multi = write(tmp_path / "multi.fastq.gz", members(recs, 600) + garbage)
    one = write(tmp_path / "one.fastq.gz", gzip.compress(b"".join(recs), 1) + garbage)
    with pytest.raises(zlib.error) as serial:
        serial_batches(multi, 768)
    with pytest.raises(zlib.error) as stream:
        read_all(one)
    with pytest.raises(zlib.error) as member:
        read_all(multi)
    assert str(member.value) == str(stream.value) == str(serial.value)
    # a header at the garbage's start is a second member start: the member path
    one_path = ("members", True) if garbage.startswith(b"\x1f\x8b") else ("stream", False)
    assert [(e["path"], e["fallback"]) for e in events()] == [one_path, ("members", True)]


def test_inflated_bytes_held_stay_within_the_window(tmp_path, monkeypatch):
    recs = fastq_text(40_000, seed=15)
    path = write(tmp_path / "r.fastq.gz", members(recs, 60))  # ~11 MB out in 667 members
    window, task = 256 << 10, 64 << 10
    monkeypatch.setattr(threaded, "_WINDOW_BYTES", window)
    monkeypatch.setattr(threaded, "_TASK_BYTES", task)
    reader = ThreadedFastqReader(path, batch_size=200, max_len=MAX_LEN, num_threads=4, prefetch=3)
    n = 0
    tracemalloc.start()
    try:
        for b in reader:
            n += b["r1_codes"].shape[0]
            del b
        held = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert n == 40_000
    # the window, the batches of the queue and in parse (~56 KB each) and
    # their parsed arrays (200 x 128 codes), against the file's ~11 MB
    assert held < window + 8 * (64 << 10) + 8 * 200 * (MAX_LEN + 64) + (1 << 20)


@pytest.fixture(scope="module")
def golden_reads(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_threaded_io")
    shutil.copy(GOLD / "lib_base.json", root / "lib_base.json")
    for mate in ("r1", "r2"):
        text = (GOLD / f"{mate}.fastq").read_bytes()
        recs = [b"".join(r) for r in zip(*[iter(text.splitlines(keepends=True))] * 4)]
        (root / f"{mate}.fastq").write_bytes(text)
        (root / f"{mate}.one.fastq.gz").write_bytes(gzip.compress(text))
        (root / f"{mate}.multi.fastq.gz").write_bytes(members(recs, 3 if mate == "r1" else 5))
    return root


@pytest.mark.parametrize("paired", [False, True])
def test_align_gives_one_tsv_for_every_layout(golden_reads, tmp_path, monkeypatch, events, paired):
    monkeypatch.setenv("NIMBLE_TPU_READER_BATCH", "4")  # batches that span members
    tsvs = {}
    for layout in ("multi.fastq.gz", "one.fastq.gz", "fastq"):
        out = tmp_path / f"{layout}.tsv"
        inputs = [str(golden_reads / f"{m}.{layout}") for m in (("r1", "r2") if paired else ("r1",))]
        assert port_cli(["align", "--reference", str(golden_reads / "lib_base.json"), "--output", str(out),
                         "--input", *inputs, "--device", "cpu", "-c", "2"]) == 0
        tsvs[layout] = out.read_bytes()
    assert tsvs["multi.fastq.gz"] == tsvs["one.fastq.gz"] == tsvs["fastq"]
    if paired:
        assert tsvs["fastq"] == (GOLD / "golden_base.tsv").read_bytes()
    paths = [e["path"] for e in events()]
    assert paths == (["members"] * 2 + ["stream"] * 2 + ["plain"] * 2 if paired
                     else ["members", "stream", "plain"])


@pytest.fixture(scope="module")
def gz_ws(ws):
    """The resume tests' workspace with its 4,000 reads also as gzip
    members of 300 records (16 spans of 256 reads; reader batches of 128)."""
    text = (ws / "reads.fastq").read_bytes()
    recs = [b"".join(r) for r in zip(*[iter(text.splitlines(keepends=True))] * 4)]
    (ws / "reads.multi.fastq.gz").write_bytes(members(recs, 300))
    return ws


def test_kill_then_resume_on_members(gz_ws, tmp_path, capsys, monkeypatch):
    base = ["align", "--reference", str(gz_ws / "library.json"), "--chunk-size", str(SPAN), "-c", "2"]
    plain, gz = [*base, "--input", str(gz_ws / "reads.fastq")], [*base, "--input", str(gz_ws / "reads.multi.fastq.gz")]
    full = tmp_path / "full.tsv"
    assert port_in_process([*plain, "--output", str(full)], capsys, monkeypatch)[0] == 0
    sidecars = []
    for args, out in ((plain, tmp_path / "plain.tsv"), (gz, tmp_path / "gz.tsv")):
        rc, log = run_proc([*args, "--output", str(out), "--device", "cpu"],
                           {"KILL_AFTER_EMITS": "6", "NIMBLE_TPU_READER_BATCH": str(SPAN // 2)})
        assert rc == 9, log
        prog = json.loads((tmp_path / f"{out.name}.progress.json").read_text())
        sidecars.append({k: list(v.values()) if isinstance(v, dict) else v for k, v in prog.items()})  # per output
        assert out.read_bytes() == full.read_bytes()[:len(out.read_bytes())]
    assert sidecars[0] == sidecars[1] and sidecars[1]["reads_done"] == 5 * SPAN
    monkeypatch.setenv("NIMBLE_TPU_READER_BATCH", str(SPAN // 2))
    rc, stdout, events = port_in_process([*gz, "--output", str(tmp_path / "gz.tsv"), "--resume"], capsys,
                                         monkeypatch, tmp_path / "resume.jsonl")
    assert rc == 0 and f"Resuming from read {5 * SPAN}" in stdout
    assert (tmp_path / "gz.tsv").read_bytes() == full.read_bytes()
    assert [(e["path"], e["members"]) for e in events if e["event"] == "reader"] == [("members", 14)]


def test_decode_sharded_world_on_members(gz_ws, tmp_path, capsys, monkeypatch):
    from tests.test_torch_multiproc import N_READS, run_world

    base = ["align", "--reference", str(gz_ws / "library.json"), "--chunk-size", str(SPAN), "-c", "2"]
    single = tmp_path / "single.tsv"
    assert port_in_process([*base, "--input", str(gz_ws / "reads.fastq"), "--output", str(single)], capsys,
                           monkeypatch)[0] == 0
    merged = tmp_path / "merged.tsv"
    rc0, out0, [(rc1, out1)] = run_world(
        [*base, "--input", str(gz_ws / "reads.multi.fastq.gz"), "--output", str(merged)], 2, capsys,
        monkeypatch, env={"NIMBLE_TPU_READER_BATCH": str(SPAN // 2)})
    assert rc0 == 0 and rc1 == 0, out1
    for out in (out0, out1):
        parsed, skipped = map(int, re.search(r"Decode shard: parsed (\d+) skipped (\d+)", out).groups())
        assert parsed + skipped == N_READS and parsed <= 0.7 * N_READS
    assert merged.read_bytes() == single.read_bytes()
