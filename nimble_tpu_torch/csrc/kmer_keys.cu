// kmer_keys: the fused window stage of the align step, for Hopper (sm_90a).
//
// Replaces nimble_tpu/align/kernels.py:kmer_keys_pallas (body
// _kmer_keys_body). For every read b and window p (P = L - k + 1 windows):
//   * packs the k bases at [p, p + k) as a 2k-bit key, first base high
//     (base = code & 3);
//   * reverse-complements it and keeps the canonical (smaller) key;
//   * flags fwd_canon (forward key <= its reverse complement), palindrome,
//     and valid (no N, code 4, in the window and p + k <= lens[b]);
//   * hashes the canonical key twice, murmur-style, masked to n_buckets - 1
//     (nimble_tpu_torch/index/hashing.py).
// Outputs are seven (B, P) planes: c_hi, c_lo, h1, h2 as int32 (uint32 bit
// patterns) and fwd_canon, palindrome, valid as 0/1 bytes.
//
// What bounds it: bytes. Each window writes 4 x 4 + 3 = 19 bytes and the
// read's codes are read once (L bytes per read), so at the group path's
// B = 65,536, L = 112, k = 26 it moves 115.9 MB: 34.6 us at 3.35 TB/s. A
// thread that packs its window's k bases itself spends O(k) loads and
// shifts (and a 64-bit division for its read index) per window: ~400
// instructions, which makes such a kernel issue-bound at several times the
// byte bound. Here every window costs O(1):
//   * one warp per read, kWarps reads per block, the read index taken from
//     blockIdx and the warp index (no division);
//   * the warp reads a segment of up to kSeg = 256 codes once, 16 per lane
//     (16-byte loads where the row is 16-byte aligned, narrower otherwise),
//     and packs it into three small arrays in shared memory: the forward
//     2-bit codes (16 a word, first base high), the reverse complement of
//     the segment packed the same way, and an N bitmask (32 a word, first
//     base low);
//   * lane i then takes the segment's windows i, i + 32, ...: the forward
//     key is the 2k-bit field at its base (two funnel shifts over three
//     words), the reverse complement the field at base 16 nw - i - k of the
//     reversed array (nw words in the segment), the N test the k-bit field
//     of the mask; then the canonical select, both hashes and seven stores
//     that are coalesced across the warp.
// Reads longer than a segment take several: segment s starts at base
// kChunk * s, kChunk = kSeg - 32 windows (a multiple of 16, so every segment
// of a 16-byte aligned row is 16-byte aligned too).
// What remains is the seven store streams: keys made without the packed
// arrays are no faster, and persistent warps that fetch the next read's
// codes ahead are slower.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kGolden = 0x9E3779B1u;
constexpr uint32_t kC1 = 0x85EBCA6Bu;
constexpr uint32_t kC2 = 0xC2B2AE35u;
constexpr uint32_t kNWord = 0x04040404u;  // four N codes
constexpr int kWarps = 8;                   // reads per block
constexpr int kSeg = 256;                   // codes per segment
constexpr int kChunk = kSeg - 32;           // windows per segment
constexpr int kFwdWords = kSeg / 16 + 2;    // + 2 zero words for the 3-word reads
constexpr int kMaskWords = kSeg / 32 + 1;   // + 1 zero word for the 2-word reads
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t mix32(uint32_t a, uint32_t b) {
  uint32_t x = a * kGolden + b;
  x ^= x >> 16;
  x *= kC1;
  x ^= x >> 13;
  x *= kC2;
  return x ^ (x >> 16);
}

// Four codes (one per byte, first code lowest) -> their four 2-bit bases,
// first base high, in the low byte.
__device__ __forceinline__ uint32_t pack4(uint32_t x) {
  return ((x & 3u) << 6) | (((x >> 8) & 3u) << 4) | (((x >> 16) & 3u) << 2) |
         ((x >> 24) & 3u);
}

// Four codes -> a 4-bit mask of those equal to N (bit j for byte j).
__device__ __forceinline__ uint32_t nbits4(uint32_t x) {
  const uint32_t m = __vcmpeq4(x, kNWord) & 0x01010101u;
  return (m | (m >> 7) | (m >> 14) | (m >> 21)) & 0xFu;
}

// Reverse the sixteen 2-bit groups of x.
__device__ __forceinline__ uint32_t rev2(uint32_t x) {
  const uint32_t r = __brev(x);
  return ((r & 0x55555555u) << 1) | ((r >> 1) & 0x55555555u);
}

// The 64 bits of a packed 2-bit array starting at base `pos`, first base
// high (words[pos / 16 .. pos / 16 + 2] must exist).
__device__ __forceinline__ uint64_t field64(const uint32_t* words, int pos) {
  const int i = pos >> 4;
  const uint32_t s = 2u * (pos & 15);
  const uint32_t w0 = words[i], w1 = words[i + 1], w2 = words[i + 2];
  const uint32_t a = __funnelshift_l(w1, w0, s);
  const uint32_t b = __funnelshift_l(w2, w1, s);
  return (static_cast<uint64_t>(a) << 32) | b;
}

// Sixteen codes at src (fewer when avail < 16; the rest read as 0) as four
// little-endian words, with the widest loads the address allows.
__device__ __forceinline__ void load16(const int8_t* src, int avail,
                                       uint32_t (&v)[4]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  if (avail >= 16 && (a & 15u) == 0) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(src));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if (avail >= 16 && (a & 3u) == 0) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(src);
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = __ldg(p + q);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (j < avail) {
        v[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(src + j)))
                     << (8 * (j & 3));
      }
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
kmer_keys_kernel(const int8_t* __restrict__ codes,
                 const int32_t* __restrict__ lens, int64_t B, int L, int k,
                 uint32_t mask, int32_t* __restrict__ c_hi,
                 int32_t* __restrict__ c_lo, int32_t* __restrict__ h1,
                 int32_t* __restrict__ h2, uint8_t* __restrict__ fwd_canon,
                 uint8_t* __restrict__ palindrome,
                 uint8_t* __restrict__ valid) {
  __shared__ uint32_t sh_fwd[kWarps][kFwdWords];
  __shared__ uint32_t sh_rc[kWarps][kFwdWords];
  __shared__ uint32_t sh_n[kWarps][kMaskWords];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (b >= B) return;  // whole warps leave together
  uint32_t* fwd = sh_fwd[warp];
  uint32_t* rc = sh_rc[warp];
  uint32_t* nm = sh_n[warp];

  const int P = L - k + 1;
  const int8_t* row = codes + b * L;
  const int len = __ldg(lens + b);
  const int64_t out0 = b * P;
  const int key_shift = 64 - 2 * k;
  const uint64_t kmask = (1ull << k) - 1;

  for (int p0 = 0; p0 < P; p0 += kChunk) {
    const int n = min(kSeg, L - p0);  // codes in this segment
    const int nw = (n + 15) >> 4;     // their 2-bit words
    const int nwin = min(kChunk, P - p0);

    // lane i packs codes [16 i, 16 i + 16) of the segment
    uint32_t fw = 0, nb = 0;
    if (lane < nw) {
      uint32_t v[4];
      load16(row + p0 + 16 * lane, n - 16 * lane, v);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        fw |= pack4(v[q]) << (24 - 8 * q);
        nb |= nbits4(v[q]) << (4 * q);
      }
    }
    const uint32_t nb_lo = __shfl_sync(kFull, nb, (2 * lane) & 31);
    const uint32_t nb_hi = __shfl_sync(kFull, nb, (2 * lane + 1) & 31);
    if (lane < kFwdWords) {
      fwd[lane] = fw;  // 0 past the segment
      // the reversed array: word nw - 1 - i is word i complemented and
      // reversed, so it starts with 16 nw - n padding bases
      if (lane < nw) {
        rc[nw - 1 - lane] = rev2(~fw);
      } else {
        rc[lane] = 0;
      }
    }
    if (lane < kMaskWords) nm[lane] = nb_lo | (nb_hi << 16);
    __syncwarp();

    for (int i = lane; i < nwin; i += 32) {
      const uint64_t f = field64(fwd, i) >> key_shift;
      const uint64_t r = field64(rc, 16 * nw - i - k) >> key_shift;
      const int mi = i >> 5;
      const uint64_t nwin_bits =
          ((static_cast<uint64_t>(nm[mi + 1]) << 32) | nm[mi]) >> (i & 31);
      const bool has_n = (nwin_bits & kmask) != 0;
      const bool is_fwd = f <= r;
      const uint64_t canon = is_fwd ? f : r;
      const uint32_t hi = static_cast<uint32_t>(canon >> 32);
      const uint32_t lo = static_cast<uint32_t>(canon);
      const int p = p0 + i;
      const int64_t t = out0 + p;
      c_hi[t] = static_cast<int32_t>(hi);
      c_lo[t] = static_cast<int32_t>(lo);
      h1[t] = static_cast<int32_t>(mix32(lo, hi) & mask);
      h2[t] = static_cast<int32_t>(mix32(hi ^ kC2, lo ^ kC1) & mask);
      fwd_canon[t] = is_fwd;
      palindrome[t] = f == r;
      valid[t] = !has_n && (p + k <= len);
    }
    __syncwarp();  // the next segment overwrites the arrays
  }
}

}  // namespace

// The library links its own CUDA runtime, whose current device is not
// PyTorch's: the caller names the device of its tensors and stream.
extern "C" int nt_kmer_keys(int device, const void* codes, const void* lens,
                            int64_t B, int L, int k, uint32_t mask, void* c_hi,
                            void* c_lo, void* h1, void* h2, void* fwd_canon,
                            void* palindrome, void* valid, void* stream) {
  if (k < 1 || k > 31 || L < k) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (B + kWarps - 1) / kWarps;
  kmer_keys_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), static_cast<const int32_t*>(lens), B,
      L, k, mask, static_cast<int32_t*>(c_hi), static_cast<int32_t*>(c_lo),
      static_cast<int32_t*>(h1), static_cast<int32_t*>(h2),
      static_cast<uint8_t*>(fwd_canon), static_cast<uint8_t*>(palindrome),
      static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}
