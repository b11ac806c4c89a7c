"""The window-stage kernel of the group-probe path: `kmer_keys`.

`kmer_keys(codes, lens, k, n_buckets)` returns the seven (B, P = L-k+1)
planes of nimble_tpu/align/kernels.py:kmer_keys_pallas — c_hi, c_lo, h1, h2
as int32 (uint32 bit patterns) and fwd_canon, palindrome, valid as bool.

On a CUDA tensor it launches the hand-written sm_90a kernel in
csrc/kmer_keys.cu, built with nvcc at first use into _build/ and bound with
ctypes (a plain C interface, so the build takes seconds, not the minutes a
build against PyTorch's headers takes). On a CPU tensor it runs
`kmer_keys_reference`, the plain torch twin. Nothing falls back from one to
the other: a CUDA launch either succeeds or raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

from nimble_tpu_torch.index.hashing import MASK32, bucket_hashes

N_CODE = 4

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in srcs:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(f.encode() + fh.read())
    return os.path.join(BUILD_DIR, f"libnimble_torch_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/*.cu into the shared library unless it is already built.
    Returns its path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    srcs = sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cu"))
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, path)  # atomic: concurrent builders never see a partial file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
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
            _lib = lib
    return _lib


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
        dev.index if dev.index is not None else torch.cuda.current_device(),
        codes.data_ptr(), lens.data_ptr(), B, L, k, n_buckets - 1,
        *[o.data_ptr() for o in outs], stream,
    )
    if err != 0:
        raise RuntimeError(f"kmer_keys kernel launch failed: cudaError {err}")
    kmer_keys.launches += 1
    return tuple(outs)


kmer_keys.launches = 0
