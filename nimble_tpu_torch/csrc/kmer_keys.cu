// kmer_keys: the fused window stage of the group-probe align step, for
// Hopper (sm_90a).
//
// Replaces nimble_tpu/align/kernels.py:kmer_keys_pallas (body
// _kmer_keys_body). For every read b and window p (P = L - k + 1 windows):
//   * packs the k bases at [p, p + k) as a 2k-bit key, first base high;
//   * reverse-complements it and keeps the canonical (smaller) key;
//   * flags fwd_canon (forward key <= its reverse complement), palindrome,
//     and valid (no N in the window and p + k <= lens[b]);
//   * hashes the canonical key twice, murmur-style, masked to n_buckets - 1
//     (nimble_tpu/index/hashing.py).
// Outputs are seven (B, P) planes: c_hi, c_lo, h1, h2 as int32 (uint32 bit
// patterns) and fwd_canon, palindrome, valid as 0/1 bytes.
//
// What bounds it: bytes written. Each window reads one new byte of codes
// (the k-byte window overlaps its neighbours' in L1) and writes 4 x 4 + 3 =
// 19 bytes, so the kernel moves ~19 B per window and does ~100 integer ops
// per window. The design keeps every store coalesced: one thread per
// (read, window), consecutive threads on consecutive windows of a read, so
// a warp's stores to each plane are contiguous. The read row is read
// through the read-only cache (__ldg). The TPU kernel's workarounds (shift
// by multiply, log-step ANDs for the N mask, lane-padded VMEM blocks) have
// no reason to exist here: keys, reverse complement and hashes are native
// 64/32-bit integer arithmetic and the N test is a flag in the packing loop.
//
// A later change may fuse the group probe (row gather + slot select) into
// this kernel so that the keys never reach device memory (ROADMAP Queue 1
// item 8).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kGolden = 0x9E3779B1u;
constexpr uint32_t kC1 = 0x85EBCA6Bu;
constexpr uint32_t kC2 = 0xC2B2AE35u;
constexpr int8_t kNCode = 4;

__device__ __forceinline__ uint32_t mix32(uint32_t a, uint32_t b) {
  uint32_t x = a * kGolden + b;
  x ^= x >> 16;
  x *= kC1;
  x ^= x >> 13;
  x *= kC2;
  return x ^ (x >> 16);
}

__global__ void kmer_keys_kernel(const int8_t* __restrict__ codes,
                                 const int32_t* __restrict__ lens,
                                 int64_t B, int L, int k, uint32_t mask,
                                 int32_t* __restrict__ c_hi,
                                 int32_t* __restrict__ c_lo,
                                 int32_t* __restrict__ h1,
                                 int32_t* __restrict__ h2,
                                 uint8_t* __restrict__ fwd_canon,
                                 uint8_t* __restrict__ palindrome,
                                 uint8_t* __restrict__ valid) {
  const int P = L - k + 1;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= B * P) return;
  const int64_t b = t / P;
  const int p = static_cast<int>(t - b * P);

  const int8_t* row = codes + b * L + p;
  uint64_t fwd = 0;  // base j at bits 2(k-1-j)
  uint64_t rc = 0;   // complement of base j at bits 2j
  bool has_n = false;
  for (int j = 0; j < k; ++j) {
    const int8_t c = __ldg(row + j);
    has_n |= (c == kNCode);
    const uint64_t v = static_cast<uint32_t>(static_cast<int32_t>(c)) & 3u;
    fwd = (fwd << 2) | v;
    rc |= (3u - v) << (2 * j);
  }
  const bool is_fwd = fwd <= rc;
  const uint64_t canon = is_fwd ? fwd : rc;
  const uint32_t hi = static_cast<uint32_t>(canon >> 32);
  const uint32_t lo = static_cast<uint32_t>(canon);

  c_hi[t] = static_cast<int32_t>(hi);
  c_lo[t] = static_cast<int32_t>(lo);
  h1[t] = static_cast<int32_t>(mix32(lo, hi) & mask);
  h2[t] = static_cast<int32_t>(mix32(hi ^ kC2, lo ^ kC1) & mask);
  fwd_canon[t] = is_fwd;
  palindrome[t] = fwd == rc;
  valid[t] = !has_n && (p + k <= __ldg(lens + b));
}

}  // namespace

// The library links its own CUDA runtime, whose current device is not
// PyTorch's: the caller names the device of its tensors and stream.
extern "C" int nt_kmer_keys(int device, const void* codes, const void* lens,
                            int64_t B, int L, int k, uint32_t mask, void* c_hi,
                            void* c_lo, void* h1, void* h2, void* fwd_canon,
                            void* palindrome, void* valid, void* stream) {
  const int64_t n = B * static_cast<int64_t>(L - k + 1);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  kmer_keys_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(codes), static_cast<const int32_t*>(lens), B,
      L, k, mask, static_cast<int32_t*>(c_hi), static_cast<int32_t*>(c_lo),
      static_cast<int32_t*>(h1), static_cast<int32_t*>(h2),
      static_cast<uint8_t*>(fwd_canon), static_cast<uint8_t*>(palindrome),
      static_cast<uint8_t*>(valid));
  return static_cast<int>(cudaGetLastError());
}
