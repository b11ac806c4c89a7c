// mono_probe: the fused mono-table probe of the mono align step, for Hopper
// (sm_90a).
//
// Replaces nimble_tpu/align/kernels.py:mono_select_pallas (body
// _mono_select_body) together with the row gather that
// nimble_tpu/align/engine.py:mono_probe runs before it. For every window t
// of a (B, P) batch of canonical keys:
//   * reads the bucket row mono_bucket[h1[t]] of S slots, laid out planar as
//     [hi x S | lo x S | vs_bits (W, S) | vd_bits (W, S)] int32 words, and
//     keeps the slot(s) whose (hi, lo) equals the query's int32 bit pattern
//     (empty slots hold hi = -1, which no canonical key has);
//   * ORs in the stash rows [hi, lo, vs_bits (W), vd_bits (W)] that match;
//   * picks the orientations: bits_f = fwd_canon ? vs : vd, bits_r =
//     palindrome ? vs : (fwd_canon ? vd : vs), both zero where !valid.
// Outputs are (B, P, W) int32, the layout of the reference's mono_probe.
//
// What bounds it: bytes read at random. Each valid window touches one
// 160-byte row of a table that is 21 MB to 2.7 GB at S = 4, W = 4 (one or
// two 128-byte lines, plus the 12 bytes of keys and 3 of flags it reads in
// order) and writes 2W words. The TPU kernel received the gathered rows
// from XLA, transposed to (RW, B, P) planes because Mosaic pads a size-S
// minor dimension to 128 lanes, so the reference moves every window's full
// row through device memory three times (gather out, transpose, kernel in).
// Here the gather is fused: one thread per window reads the S hi and S lo
// words (two 16-byte loads at S = 4), then only the matched slot's 2W
// words, and the row never exists outside registers. Invalid windows (N
// bases, read padding) skip the row entirely. The stash (at most
// MONO_MAX_STASH = 64 rows) is swept from shared memory.
//
// S comes from the row width and W is an argument, so the stacked engine's
// narrower buckets and concatenated W fit the same kernel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxStash = 64;  // the stash-match mask is one 64-bit word
constexpr int kMaxSlots = 32;  // the slot-match mask is one 32-bit word

__global__ void mono_probe_kernel(const int32_t* __restrict__ bucket,
                                  int64_t nb2, int S, int W, bool vec4,
                                  const int32_t* __restrict__ h1,
                                  const int32_t* __restrict__ hi,
                                  const int32_t* __restrict__ lo,
                                  const uint8_t* __restrict__ fwd_canon,
                                  const uint8_t* __restrict__ palindrome,
                                  const uint8_t* __restrict__ valid, int64_t n,
                                  const int32_t* __restrict__ stash,
                                  int n_stash, int32_t* __restrict__ bits_f,
                                  int32_t* __restrict__ bits_r) {
  extern __shared__ int32_t sh_stash[];
  const int E = 2 + 2 * W;  // words per slot entry and per stash row
  for (int i = threadIdx.x; i < n_stash * E; i += blockDim.x) {
    sh_stash[i] = stash[i];
  }
  __syncthreads();

  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  int32_t* out_f = bits_f + t * W;
  int32_t* out_r = bits_r + t * W;
  if (!__ldg(valid + t)) {
    for (int w = 0; w < W; ++w) {
      out_f[w] = 0;
      out_r[w] = 0;
    }
    return;
  }
  const int32_t qhi = __ldg(hi + t);
  const int32_t qlo = __ldg(lo + t);
  const uint32_t h = static_cast<uint32_t>(__ldg(h1 + t));

  // bit s: slot s holds the query key. An out-of-range hash reads no row.
  uint32_t slots = 0;
  const int32_t* row = bucket;
  if (static_cast<int64_t>(h) < nb2) {
    row = bucket + static_cast<int64_t>(h) * S * E;  // 64-bit row offset
    if (vec4) {
      const int4 khi = __ldg(reinterpret_cast<const int4*>(row));
      const int4 klo = __ldg(reinterpret_cast<const int4*>(row + 4));
      slots = static_cast<uint32_t>(khi.x == qhi && klo.x == qlo) |
              static_cast<uint32_t>(khi.y == qhi && klo.y == qlo) << 1 |
              static_cast<uint32_t>(khi.z == qhi && klo.z == qlo) << 2 |
              static_cast<uint32_t>(khi.w == qhi && klo.w == qlo) << 3;
    } else {
      for (int s = 0; s < S; ++s) {
        slots |= static_cast<uint32_t>(__ldg(row + s) == qhi &&
                                       __ldg(row + S + s) == qlo)
                 << s;
      }
    }
  }
  uint64_t stashed = 0;  // bit r: stash row r holds the query key
  for (int r = 0; r < n_stash; ++r) {
    stashed |= static_cast<uint64_t>(sh_stash[r * E] == qhi &&
                                     sh_stash[r * E + 1] == qlo)
               << r;
  }

  const bool fc = __ldg(fwd_canon + t) != 0;
  const bool pal = __ldg(palindrome + t) != 0;
  for (int w = 0; w < W; ++w) {
    int32_t vs = 0;
    int32_t vd = 0;
    for (uint32_t m = slots; m != 0; m &= m - 1) {
      const int s = __ffs(static_cast<int>(m)) - 1;
      vs |= __ldg(row + 2 * S + w * S + s);
      vd |= __ldg(row + 2 * S + (W + w) * S + s);
    }
    for (uint64_t m = stashed; m != 0; m &= m - 1) {
      const int r = __ffsll(static_cast<long long>(m)) - 1;
      vs |= sh_stash[r * E + 2 + w];
      vd |= sh_stash[r * E + 2 + W + w];
    }
    out_f[w] = fc ? vs : vd;
    out_r[w] = pal ? vs : (fc ? vd : vs);
  }
}

}  // namespace

// The library links its own CUDA runtime, whose current device is not
// PyTorch's: the caller names the device of its tensors and stream.
// bucket (nb2, S * (2 + 2W)) int32; h1, hi, lo (n,) int32; fwd_canon,
// palindrome, valid (n,) bytes; stash (n_stash, 2 + 2W) int32; bits_f and
// bits_r (n, W) int32. All contiguous.
extern "C" int nt_mono_probe(int device, const void* bucket, int64_t nb2,
                             int S, int W, const void* h1, const void* hi,
                             const void* lo, const void* fwd_canon,
                             const void* palindrome, const void* valid,
                             int64_t n, const void* stash, int n_stash,
                             void* bits_f, void* bits_r, void* stream) {
  if (S < 1 || S > kMaxSlots || W < 1 || n_stash < 0 || n_stash > kMaxStash) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // two 16-byte key loads need S = 4 and a 16-byte aligned table; every
  // row is then aligned too (4 * (2 + 2W) words is a multiple of 4)
  const bool vec4 = S == 4 && reinterpret_cast<uintptr_t>(bucket) % 16 == 0;
  const size_t smem = static_cast<size_t>(n_stash) * (2 + 2 * W) * sizeof(int32_t);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(mono_probe_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  mono_probe_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bucket), nb2, S, W, vec4,
      static_cast<const int32_t*>(h1), static_cast<const int32_t*>(hi),
      static_cast<const int32_t*>(lo), static_cast<const uint8_t*>(fwd_canon),
      static_cast<const uint8_t*>(palindrome),
      static_cast<const uint8_t*>(valid), n,
      static_cast<const int32_t*>(stash), n_stash,
      static_cast<int32_t*>(bits_f), static_cast<int32_t*>(bits_r));
  return static_cast<int>(cudaGetLastError());
}
