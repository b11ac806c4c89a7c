"""The hand-written kernels of the align paths and their plain torch
versions.

`kmer_keys(codes, lens, k, n_buckets)` returns the seven (B, P = L-k+1)
planes of nimble_tpu/align/kernels.py:kmer_keys_pallas — c_hi, c_lo, h1, h2
as int32 (uint32 bit patterns) and fwd_canon, palindrome, valid as bool.

`mono_probe(bucket, h1, hi_i, lo_i, fwd_canon, palindrome, valid, stash, W)`
returns the (B, P, W) bits_f and bits_r of nimble_tpu/align/engine.py:
mono_probe: the mono-table row gather, slot select, stash sweep and
orientation select that the reference splits between XLA and
kernels.py:mono_select_pallas.

`band_tree_expand(gband_page, gband_band, idx_sel, has_sel, W)` returns the
(B, W) bits of the wide gband path: the band-row gather of
nimble_tpu/align/engine.py:_score_mate_groupband followed by what
kernels.py:band_tree_expand_pallas computes — the AND of each read's
page-banded rows and its expansion to W words — on the gband table re-laid
on the card as a page vector and aligned band rows (tables.relayout_gband).
The kernel computes the fold in closed form from the highest and lowest
contributing page (one page pass and one band pass per read); the plain
version keeps the reference's halving tree.

`intersect_class_bits(class_ids, matched, class_bits)` returns the (B, W)
bits of the class-id paths (groupcls, monocls, the wide two-choice probe):
the AND of the class_bits rows at each read's matched positions, which the
reference leaves to XLA (nimble_tpu/align/engine.py:intersect_class_bits, a
row gather for W <= 32, a while_loop over run-start blocks above). The
kernel walks each read's own runs; the plain version keeps the reference's
two branches, its block loop run to the static bound ceil(P / RUN_BLOCK).

On CUDA tensors each wrapper launches its hand-written sm_90a kernel
(csrc/kmer_keys.cu, csrc/mono_probe.cu, csrc/band_tree_expand.cu,
csrc/intersect_class_bits.cu), built with nvcc at first use into _build/
and bound with ctypes (a plain C interface, so the build takes seconds,
not the minutes a build against PyTorch's headers takes). On CPU tensors
it runs the plain torch version (`kmer_keys_reference`,
`mono_probe_reference`, `band_tree_expand_reference`,
`intersect_class_bits_reference`). Nothing falls back from one to the
other: a CUDA launch either succeeds or raises. Each wrapper counts its kernel
launches in `<wrapper>.launches`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

from nimble_tpu_torch.align.tables import MONO_MAX_STASH
from nimble_tpu_torch.index.hashing import MASK32, bucket_hashes
from nimble_tpu_torch.observability import runlog

N_CODE = 4

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]
# each kernel's registers, shared memory and spills, kept beside the library
PTXAS_FLAGS = ["-Xptxas", "-v"]

_lib = None
_lib_lock = threading.Lock()


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> int32 with the same bit pattern."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _rev2_32(y: torch.Tensor) -> torch.Tensor:
    """Reverse the sixteen 2-bit groups of a 32-bit value (int64 holding it)."""
    y = ((y & 0x33333333) << 2) | ((y >> 2) & 0x33333333)
    y = ((y & 0x0F0F0F0F) << 4) | ((y >> 4) & 0x0F0F0F0F)
    y = ((y & 0x00FF00FF) << 8) | ((y >> 8) & 0x00FF00FF)
    return ((y << 16) & MASK32) | (y >> 16)


def kmer_hi_lo(codes: torch.Tensor, lens: torch.Tensor, k: int):
    """engine.py:kmer_hi_lo — (B, L) int8 codes -> forward k-mer (hi, lo) as
    int64 in [0, 2^32) at each of P = L-k+1 windows, plus validity."""
    B, L = codes.shape
    P = L - k + 1
    if P < 1:
        raise ValueError(f"reads of width {L} are shorter than k={k}")
    c = codes.long()
    hi = torch.zeros((B, P), dtype=torch.int64, device=codes.device)
    lo = torch.zeros_like(hi)
    for j in range(k):
        bitpos = 2 * (k - 1 - j)
        window = c[:, j : j + P] & 3
        if bitpos >= 32:
            hi |= window << (bitpos - 32)
        else:
            lo |= window << bitpos
    bad = (codes == N_CODE).to(torch.int32)
    bad_cum = torch.cat(
        [torch.zeros((B, 1), dtype=torch.int64, device=codes.device),
         torch.cumsum(bad, dim=1)],
        dim=1,
    )
    no_n = (bad_cum[:, k:] - bad_cum[:, :-k]) == 0
    pos = torch.arange(P, device=codes.device)[None, :]
    inside = pos + k <= lens.long()[:, None]
    return hi, lo, no_n & inside


def revcomp_hi_lo(hi: torch.Tensor, lo: torch.Tensor, k: int):
    """engine.py:revcomp_hi_lo on int64-held uint32 words: complement all 64
    bits, reverse the 2-bit groups, shift right by 64-2k."""
    nh = _rev2_32(lo ^ MASK32)  # reversed 64-bit: the high word comes from lo
    nl = _rev2_32(hi ^ MASK32)
    s = 64 - 2 * k
    if s >= 32:
        out_lo = nh >> (s - 32)
        out_hi = torch.zeros_like(nh)
    else:
        out_lo = ((nl >> s) | (nh << (32 - s))) & MASK32
        out_hi = nh >> s
    if 2 * k > 32:
        out_hi = out_hi & ((1 << (2 * k - 32)) - 1)
    else:
        out_hi = torch.zeros_like(out_hi)
        if 2 * k < 32:
            out_lo = out_lo & ((1 << (2 * k)) - 1)
    return out_hi, out_lo


def canonical_keys(hi: torch.Tensor, lo: torch.Tensor, k: int):
    """engine.py:_canonical_keys -> (c_hi, c_lo, fwd_is_canon, palindrome)."""
    rc_hi, rc_lo = revcomp_hi_lo(hi, lo, k)
    fwd = (hi < rc_hi) | ((hi == rc_hi) & (lo <= rc_lo))
    pal = (hi == rc_hi) & (lo == rc_lo)
    return torch.where(fwd, hi, rc_hi), torch.where(fwd, lo, rc_lo), fwd, pal


def kmer_keys_reference(codes: torch.Tensor, lens: torch.Tensor, k: int,
                        n_buckets: int):
    """The plain torch twin of the kernel, in int64: kmer_hi_lo +
    revcomp_hi_lo + _canonical_keys + the bucket hashes."""
    hi, lo, valid = kmer_hi_lo(codes, lens, k)
    c_hi, c_lo, fwd, pal = canonical_keys(hi, lo, k)
    h1, h2 = bucket_hashes(c_hi, c_lo, n_buckets)
    return (_to_i32(c_hi), _to_i32(c_lo), h1.to(torch.int32),
            h2.to(torch.int32), fwd, pal, valid)


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); cannot build the CUDA kernels")
    return found


def library_path() -> str:
    """Path of the built kernel library, keyed by a hash of the sources and
    flags so that an edit rebuilds it."""
    srcs = sorted(f for f in os.listdir(CSRC) if f.endswith(".cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS + PTXAS_FLAGS).encode())
    for f in srcs:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode() + fh.read())
    return os.path.join(BUILD_DIR, f"libnimble_torch_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/*.cu into the shared library unless it is already built:
    one nvcc per source, all started together, then one link (the run log's
    `kernel_build` event). Returns its path; what ptxas said of each kernel
    is in `<path>.ptxas.txt`."""
    path = library_path()
    if os.path.exists(path):
        return path
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    srcs = sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cu"))
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in srcs]
        procs = [
            subprocess.Popen([_nvcc(), *NVCC_FLAGS, *PTXAS_FLAGS, "-c", "-o", o, s],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for s, o in zip(srcs, objs)
        ]
        failed, logs = [], []
        for s, p in zip(srcs, procs):
            _, err = p.communicate()
            if p.returncode != 0:
                failed.append(f"{os.path.basename(s)} ({p.returncode}):\n{err}")
            logs.append(f"== {os.path.basename(s)}\n{err}")
        if failed:
            raise RuntimeError("nvcc failed on " + "\n".join(failed))
        with open(path + ".ptxas.txt", "w") as f:
            f.write("\n".join(logs))
        so = os.path.join(tmp, "lib.so")
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", so, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
        os.replace(so, path)  # atomic: concurrent builders never see a partial file
    runlog().event("kernel_build", path=path, sources=len(srcs), wall_s=round(time.perf_counter() - t0, 4))
    return path


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.nt_kmer_keys.restype = ctypes.c_int
            lib.nt_kmer_keys.argtypes = [
                ctypes.c_int,  # device
                ctypes.c_void_p, ctypes.c_void_p,  # codes, lens
                ctypes.c_int64, ctypes.c_int, ctypes.c_int,  # B, L, k
                ctypes.c_uint32,  # n_buckets - 1
                *[ctypes.c_void_p] * 7,  # the 7 output planes
                ctypes.c_void_p,  # stream
            ]
            lib.nt_mono_probe.restype = ctypes.c_int
            lib.nt_mono_probe.argtypes = [
                ctypes.c_int,  # device
                ctypes.c_void_p, ctypes.c_int64,  # bucket, nb2
                ctypes.c_int, ctypes.c_int,  # S, W
                *[ctypes.c_void_p] * 6,  # h1, hi, lo, fwd_canon, palindrome, valid
                ctypes.c_int64,  # windows
                ctypes.c_void_p, ctypes.c_int,  # stash, n_stash
                ctypes.c_void_p, ctypes.c_void_p,  # bits_f, bits_r
                ctypes.c_void_p,  # stream
            ]
            lib.nt_intersect_class_bits.restype = ctypes.c_int
            lib.nt_intersect_class_bits.argtypes = [
                ctypes.c_int,  # device
                ctypes.c_void_p, ctypes.c_void_p,  # class_ids, matched
                ctypes.c_int64, ctypes.c_int,  # B, P
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,  # class_bits, C, W
                ctypes.c_void_p,  # out
                ctypes.c_void_p,  # stream
            ]
            lib.nt_band_tree_expand.restype = ctypes.c_int
            lib.nt_band_tree_expand.argtypes = [
                ctypes.c_int,  # device
                ctypes.c_void_p, ctypes.c_void_p,  # pages, bands
                ctypes.c_int64, ctypes.c_int,  # n_rows, Pw
                ctypes.c_void_p, ctypes.c_void_p,  # idx_sel, has_sel
                ctypes.c_int64, ctypes.c_int, ctypes.c_int,  # B, Q1, W
                ctypes.c_void_p,  # out
                ctypes.c_void_p,  # stream
            ]
            _lib = lib
    return _lib


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def kmer_keys(codes: torch.Tensor, lens: torch.Tensor, k: int, n_buckets: int):
    """The fused window stage. codes (B, L) int8 (bases 0-3, N = 4), lens (B,)
    int32, 1 <= k <= 31, n_buckets a power of two -> (c_hi, c_lo, h1, h2,
    fwd_canon, palindrome, valid), each (B, L-k+1)."""
    if codes.dim() != 2 or codes.dtype != torch.int8:
        raise ValueError(f"codes must be (B, L) int8, got {tuple(codes.shape)} {codes.dtype}")
    if lens.dtype != torch.int32 or lens.shape != (codes.shape[0],):
        raise ValueError(f"lens must be (B,) int32, got {tuple(lens.shape)} {lens.dtype}")
    if lens.device != codes.device:
        raise ValueError(f"codes on {codes.device} but lens on {lens.device}")
    if not 1 <= k <= 31:
        raise ValueError(f"k must be in [1, 31], got {k}")
    if n_buckets < 1 or n_buckets & (n_buckets - 1):
        raise ValueError(f"n_buckets must be a power of two, got {n_buckets}")
    B, L = codes.shape
    P = L - k + 1
    if P < 1:
        raise ValueError(f"reads of width {L} are shorter than k={k}")
    if codes.device.type == "cpu":
        return kmer_keys_reference(codes, lens, k, n_buckets)
    if codes.device.type != "cuda":
        raise ValueError(f"kmer_keys runs on cuda or cpu tensors, got {codes.device}")
    if not (codes.is_contiguous() and lens.is_contiguous()):
        raise ValueError("kmer_keys needs contiguous codes and lens")
    lib = _load()
    dev = codes.device
    outs = [torch.empty((B, P), dtype=torch.int32, device=dev) for _ in range(4)]
    outs += [torch.empty((B, P), dtype=torch.bool, device=dev) for _ in range(3)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.nt_kmer_keys(
        _device_index(dev), codes.data_ptr(), lens.data_ptr(), B, L, k, n_buckets - 1,
        *[o.data_ptr() for o in outs], stream,
    )
    if err != 0:
        raise RuntimeError(f"kmer_keys kernel launch failed: cudaError {err}")
    kmer_keys.launches += 1
    return tuple(outs)


kmer_keys.launches = 0


def mono_probe_reference(bucket: torch.Tensor, h1: torch.Tensor, hi_i: torch.Tensor,
                         lo_i: torch.Tensor, fwd_canon: torch.Tensor,
                         palindrome: torch.Tensor, valid: torch.Tensor,
                         stash: torch.Tensor, W: int):
    """The plain torch version of the kernel: engine.py:mono_probe's XLA
    branch after the row gather `bucket[h1]`, on the slot-major table that
    the kernel reads (tables.relayout_mono). Slot select by key compare
    (empty slots hold hi = -1, which no canonical key has), sum-select of
    the one matching slot, stash OR, orientation select, invalid windows
    zeroed."""
    B, P = hi_i.shape
    S = bucket.shape[1] // (2 + 2 * W)
    row = bucket[h1.long()]  # (B, P, S * (2 + 2W))
    match = (row[..., 0:S] == hi_i[..., None]) & (row[..., S : 2 * S] == lo_i[..., None])
    sel = match[..., None, None]  # (B, P, S, 1, 1)
    vals = row[..., 2 * S :].reshape(B, P, S, 2, W)
    zero = torch.zeros((), dtype=torch.int32, device=bucket.device)
    # at most one slot matches (keys are unique): the int64 sum holds
    # exactly that slot's int32 word
    vsd = torch.where(sel, vals, zero).sum(dim=2).to(torch.int32)  # (B, P, 2, W)
    vs, vd = vsd[:, :, 0], vsd[:, :, 1]
    for s in range(stash.shape[0]):
        m = ((stash[s, 0] == hi_i) & (stash[s, 1] == lo_i))[..., None]
        vs = vs | torch.where(m, stash[s, 2 : 2 + W], zero)
        vd = vd | torch.where(m, stash[s, 2 + W :], zero)
    fc = fwd_canon[..., None]
    bits_f = torch.where(fc, vs, vd)
    bits_r = torch.where(palindrome[..., None], vs, torch.where(fc, vd, vs))
    v = valid[..., None]
    return torch.where(v, bits_f, zero), torch.where(v, bits_r, zero)


def mono_probe(bucket: torch.Tensor, h1: torch.Tensor, hi_i: torch.Tensor,
               lo_i: torch.Tensor, fwd_canon: torch.Tensor, palindrome: torch.Tensor,
               valid: torch.Tensor, stash: torch.Tensor, W: int):
    """The fused mono probe. bucket (nb2, S*(2+2W)) int32 mono table, laid
    out slot-major (tables.relayout_mono); h1, hi_i, lo_i (B, P) int32
    (bucket hash and canonical key bit patterns);
    fwd_canon, palindrome, valid (B, P) bool; stash (n_stash, 2+2W) int32
    rows [hi, lo, vs_bits, vd_bits] -> (bits_f, bits_r), each (B, P, W)
    int32. Every tensor must be contiguous and on one device."""
    if W < 1:
        raise ValueError(f"W must be >= 1, got {W}")
    E = 2 + 2 * W
    if bucket.dim() != 2 or bucket.dtype != torch.int32 or bucket.shape[1] % E or bucket.shape[1] == 0:
        raise ValueError(f"bucket must be (nb2, S*{E}) int32, got {tuple(bucket.shape)} {bucket.dtype}")
    if stash.dim() != 2 or stash.dtype != torch.int32 or stash.shape[1] != E:
        raise ValueError(f"stash must be (n_stash, {E}) int32, got {tuple(stash.shape)} {stash.dtype}")
    if stash.shape[0] > MONO_MAX_STASH:  # the kernel's stash-match mask is 64 bits
        raise ValueError(f"stash holds {stash.shape[0]} rows, more than {MONO_MAX_STASH}")
    if hi_i.dim() != 2:
        raise ValueError(f"hi_i must be (B, P), got {tuple(hi_i.shape)}")
    planes = {"h1": h1, "hi_i": hi_i, "lo_i": lo_i, "fwd_canon": fwd_canon,
              "palindrome": palindrome, "valid": valid}
    for name, a in planes.items():
        want = torch.bool if name in ("fwd_canon", "palindrome", "valid") else torch.int32
        if a.dtype != want or a.shape != hi_i.shape:
            raise ValueError(f"{name} must be {tuple(hi_i.shape)} {want}, got {tuple(a.shape)} {a.dtype}")
    tensors = [bucket, stash, *planes.values()]
    dev = bucket.device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"mono_probe needs every tensor on one device, got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mono_probe needs contiguous tensors (make strided key planes contiguous first)")
    if dev.type == "cpu":
        return mono_probe_reference(bucket, h1, hi_i, lo_i, fwd_canon, palindrome, valid, stash, W)
    if dev.type != "cuda":
        raise ValueError(f"mono_probe runs on cuda or cpu tensors, got {dev}")
    lib = _load()
    B, P = hi_i.shape
    bits_f = torch.empty((B, P, W), dtype=torch.int32, device=dev)
    bits_r = torch.empty((B, P, W), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.nt_mono_probe(
        _device_index(dev), bucket.data_ptr(), bucket.shape[0], bucket.shape[1] // E, W,
        *[a.data_ptr() for a in planes.values()], B * P,
        stash.data_ptr(), stash.shape[0], bits_f.data_ptr(), bits_r.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"mono_probe kernel launch failed: cudaError {err}")
    mono_probe.launches += 1
    return bits_f, bits_r


mono_probe.launches = 0


def band_combine(p1, b1, h1, p2, b2, h2, Pw: int):
    """engine.py:_band_combine — AND of two page-banded values (page (..,),
    band (.., 2 Pw), has (..,)) in the frame of the higher page: pages that
    differ by one align their overlapping page, a larger gap gives an empty
    band. A side without `has` contributes nothing."""
    zeros = torch.zeros_like(b1[..., :Pw])
    up1 = torch.cat([b1[..., Pw:], zeros], dim=-1)
    up2 = torch.cat([b2[..., Pw:], zeros], dim=-1)
    d = p2 - p1
    zero = torch.zeros((), dtype=b1.dtype, device=b1.device)
    nb = torch.where((d == 0)[..., None], b1 & b2, zero)
    nb = torch.where((d == 1)[..., None], up1 & b2, nb)
    nb = torch.where((d == -1)[..., None], b1 & up2, nb)
    both = h1 & h2
    band = torch.where(both[..., None], nb, torch.where(h1[..., None], b1, b2))
    page = torch.where(both, torch.maximum(p1, p2), torch.where(h1, p1, p2))
    return page, band, h1 | h2


def band_tree(page, band, has, Pw: int):
    """engine.py:_band_tree — halving-tree reduce of (B, n, ...) banded
    values over axis 1, the odd leftover folded into slot 0."""
    n = page.shape[1]
    while n > 1:
        half = n // 2
        pg, bd, hs = band_combine(
            page[:, :half], band[:, :half], has[:, :half],
            page[:, half : 2 * half], band[:, half : 2 * half], has[:, half : 2 * half], Pw,
        )
        if n % 2:
            p0, b0, h0 = band_combine(pg[:, :1], bd[:, :1], hs[:, :1],
                                      page[:, -1:], band[:, -1:], has[:, -1:], Pw)
            pg = torch.cat([p0, pg[:, 1:]], dim=1)
            bd = torch.cat([b0, bd[:, 1:]], dim=1)
            hs = torch.cat([h0, hs[:, 1:]], dim=1)
        page, band, has = pg, bd, hs
        n = half
    return page[:, 0], band[:, 0], has[:, 0]


def expand_band(page, band, has, W: int, Pw: int):
    """engine.py:_expand_band — (B,) pages and (B, 2 Pw) bands -> (B, W)
    bitsets: output page p holds the band's lower half where page == p and
    its upper half where page == p - 1; rows without `has` are zero."""
    n_pages = -(-W // Pw) + 1
    zero = torch.zeros((), dtype=band.dtype, device=band.device)
    lo, hi = band[:, :Pw], band[:, Pw:]
    parts = []
    for pg in range(n_pages):
        seg = torch.where((page == pg)[:, None], lo, zero)
        if pg > 0:
            seg = seg | torch.where((page == pg - 1)[:, None], hi, zero)
        parts.append(seg)
    out = torch.cat(parts, dim=1)[:, :W]
    return torch.where(has[:, None], out, zero)


def band_tree_expand_reference(gband_page: torch.Tensor, gband_band: torch.Tensor, idx_sel: torch.Tensor,
                               has_sel: torch.Tensor, W: int) -> torch.Tensor:
    """The plain torch version of the kernel, on the same re-laid table: the
    (B, Q1) page and (B, Q1, 2 Pw) band gather of engine.py:
    _score_mate_groupband's XLA branch (indices clamped into the table, as a
    jnp gather clamps them), then band_tree and expand_band."""
    Pw = gband_band.shape[1] // 2
    idx = idx_sel.long().clamp(0, gband_band.shape[0] - 1)
    page, band, has = band_tree(gband_page[idx], gband_band[idx], has_sel, Pw)
    return expand_band(page, band, has, W, Pw)


def band_tree_expand(gband_page: torch.Tensor, gband_band: torch.Tensor, idx_sel: torch.Tensor,
                     has_sel: torch.Tensor, W: int) -> torch.Tensor:
    """The fused band gather + intersection + expansion of the gband path,
    on the gband table as device_tables ships it (tables.relayout_gband):
    gband_page (n_rows,) int32 and gband_band (n_rows, 2 Pw) int32, Pw a
    multiple of 8 with 3 Pw <= W, as the table builder makes it; idx_sel
    (B, Q1) int32 row index per probe position (any value where has_sel is
    False); has_sel (B, Q1) bool -> bits (B, W) int32. Every tensor must be
    contiguous and on one device."""
    if gband_band.dim() != 2 or gband_band.dtype != torch.int32 or gband_band.shape[0] < 1:
        raise ValueError(f"gband_band must be (n_rows >= 1, 2 Pw) int32, got "
                         f"{tuple(gband_band.shape)} {gband_band.dtype}")
    Pw = gband_band.shape[1] // 2
    if gband_band.shape[1] % 2 or Pw < 8 or Pw % 8 or 3 * Pw > W:
        raise ValueError(f"Pw must be a multiple of 8 with 3 * Pw <= W, got bands of "
                         f"{gband_band.shape[1]} words and W={W}")
    if gband_page.dtype != torch.int32 or gband_page.shape != gband_band.shape[:1]:
        raise ValueError(f"gband_page must be ({gband_band.shape[0]},) int32, got "
                         f"{tuple(gband_page.shape)} {gband_page.dtype}")
    if idx_sel.dim() != 2 or idx_sel.dtype != torch.int32:
        raise ValueError(f"idx_sel must be (B, Q1) int32, got {tuple(idx_sel.shape)} {idx_sel.dtype}")
    if has_sel.dtype != torch.bool or has_sel.shape != idx_sel.shape:
        raise ValueError(f"has_sel must be {tuple(idx_sel.shape)} bool, got "
                         f"{tuple(has_sel.shape)} {has_sel.dtype}")
    tensors = (gband_page, gband_band, idx_sel, has_sel)
    dev = gband_band.device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"band_tree_expand needs every tensor on one device, got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("band_tree_expand needs contiguous tensors")
    if dev.type == "cpu":
        return band_tree_expand_reference(gband_page, gband_band, idx_sel, has_sel, W)
    if dev.type != "cuda":
        raise ValueError(f"band_tree_expand runs on cuda or cpu tensors, got {dev}")
    lib = _load()
    B, Q1 = idx_sel.shape
    out = torch.empty((B, W), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.nt_band_tree_expand(
        _device_index(dev), gband_page.data_ptr(), gband_band.data_ptr(), gband_band.shape[0], Pw,
        idx_sel.data_ptr(), has_sel.data_ptr(), B, Q1, W, out.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"band_tree_expand kernel launch failed: cudaError {err}")
    band_tree_expand.launches += 1
    return out


band_tree_expand.launches = 0


# run-start classes gathered at a time by the plain version's wide branch
# (nimble_tpu/align/engine.py:127)
RUN_BLOCK = 8


def _and_tree(rows: torch.Tensor) -> torch.Tensor:
    """AND of (B, n, W) rows over axis 1 by a halving tree -> (B, W)."""
    n = rows.shape[1]
    while n > 1:
        half = n // 2
        lower = rows[:, :half] & rows[:, half : 2 * half]
        if n % 2:
            lower[:, 0] &= rows[:, -1]
        rows = lower
        n = half
    return rows[:, 0]


def and_reduce_bits(rows: torch.Tensor, matched: torch.Tensor) -> torch.Tensor:
    """engine.py:and_reduce_bits — AND (B, P, W) bitset rows over matched
    positions -> (B, W). Misses contribute all ones; reads with no matched
    position end all-zero."""
    acc = _and_tree(torch.where(matched[..., None], rows, torch.full((), -1, dtype=rows.dtype, device=rows.device)))
    return torch.where(matched.any(dim=1)[:, None], acc, torch.zeros_like(acc))


def intersect_class_bits_reference(class_ids: torch.Tensor, matched: torch.Tensor,
                                   class_bits: torch.Tensor) -> torch.Tensor:
    """The plain torch version of the kernel: engine.py:intersect_class_bits
    — the AND of the class bitsets of the matched positions' classes ->
    (B, W) int32; misses contribute all ones, reads with no matched
    position end all-zero.

    W <= 32: one (B, P, W) gather and and_reduce_bits. W > 32: runs
    compacted, as the reference: one row per run of equal consecutive class
    ids (AND is idempotent), the runs' first classes gathered RUN_BLOCK at a
    time. The reference's while_loop stops after ceil(max_runs / RUN_BLOCK)
    blocks, a count read off the data; every block past it selects no class
    and ANDs all-ones. So this loop runs the static ceil(P / RUN_BLOCK)
    blocks and gives the same bits without reading max_runs back to the
    host: the step never waits on the card. A run's class lands in slot
    `rank` of a (B, P) table by one scatter (the reference's one-hot rank
    compare, which selects the same class per slot)."""
    B, P = class_ids.shape
    dev = class_ids.device
    if class_bits.shape[1] <= 32:
        return and_reduce_bits(class_bits[class_ids.clamp(min=0).long()], matched)
    neg = torch.full((), -1, dtype=torch.int32, device=dev)
    cls = torch.where(matched, class_ids, neg)
    prev = torch.cat([torch.full((B, 1), -2, dtype=torch.int32, device=dev), cls[:, :-1]], dim=1)
    newrun = matched & (cls != prev)  # run starts (over-marking is harmless)
    rank = torch.cumsum(newrun.to(torch.int32), dim=1, dtype=torch.int32) - 1
    n_slots = -(-P // RUN_BLOCK) * RUN_BLOCK
    # slot n_slots takes every position that starts no run; it is dropped
    slots = torch.full((B, n_slots + 1), -1, dtype=torch.int32, device=dev)
    slots.scatter_(1, torch.where(newrun, rank, n_slots).long(), cls)
    acc = torch.full((B, class_bits.shape[1]), -1, dtype=torch.int32, device=dev)
    for base in range(0, n_slots, RUN_BLOCK):
        ids = slots[:, base : base + RUN_BLOCK]
        rows = torch.where(ids[..., None] >= 0, class_bits[ids.clamp(min=0).long()], neg)
        acc &= _and_tree(rows)
    return torch.where(matched.any(dim=1)[:, None], acc, torch.zeros_like(acc))


def intersect_class_bits(class_ids: torch.Tensor, matched: torch.Tensor,
                         class_bits: torch.Tensor) -> torch.Tensor:
    """The class-bits intersection of the class-id paths: class_ids (B, P)
    int32 (-1 a miss), matched (B, P) bool, class_bits (C, W) int32 ->
    bits (B, W) int32, the AND of the class rows at each read's matched
    positions (unmatched positions contribute all ones, a read with no
    matched position ends all-zero). Every tensor must be contiguous and on
    one device."""
    if class_ids.dim() != 2 or class_ids.dtype != torch.int32 or class_ids.shape[1] < 1:
        raise ValueError(f"class_ids must be (B, P >= 1) int32, got {tuple(class_ids.shape)} {class_ids.dtype}")
    if matched.dtype != torch.bool or matched.shape != class_ids.shape:
        raise ValueError(f"matched must be {tuple(class_ids.shape)} bool, got {tuple(matched.shape)} {matched.dtype}")
    if class_bits.dim() != 2 or class_bits.dtype != torch.int32 or min(class_bits.shape) < 1:
        raise ValueError(f"class_bits must be (C >= 1, W >= 1) int32, got "
                         f"{tuple(class_bits.shape)} {class_bits.dtype}")
    tensors = (class_ids, matched, class_bits)
    dev = class_bits.device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"intersect_class_bits needs every tensor on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("intersect_class_bits needs contiguous tensors")
    if dev.type == "cpu":
        return intersect_class_bits_reference(class_ids, matched, class_bits)
    if dev.type != "cuda":
        raise ValueError(f"intersect_class_bits runs on cuda or cpu tensors, got {dev}")
    lib = _load()
    B, P = class_ids.shape
    C, W = class_bits.shape
    out = torch.empty((B, W), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.nt_intersect_class_bits(
        _device_index(dev), class_ids.data_ptr(), matched.data_ptr(), B, P, class_bits.data_ptr(), C, W,
        out.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"intersect_class_bits kernel launch failed: cudaError {err}")
    intersect_class_bits.launches += 1
    return out


intersect_class_bits.launches = 0
