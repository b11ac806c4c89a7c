// mono_probe: the fused mono-table probe of the mono align step, for Hopper
// (sm_90a).
//
// Replaces nimble_tpu/align/kernels.py:mono_select_pallas (body
// _mono_select_body) together with the row gather that
// nimble_tpu/align/engine.py:mono_probe runs before it. For every window t
// of a (B, P) batch of canonical keys:
//   * reads the bucket row mono_bucket[h1[t]] of S slots, which the port
//     lays out slot-major on the card (align/tables.py:relayout_mono) as
//     [hi x S | lo x S | slot 0: vs_bits (W), vd_bits (W) | slot 1: ...]
//     int32 words, and keeps the slot(s) whose (hi, lo) equals the query's
//     int32 bit pattern (empty slots hold hi = -1, which no canonical key
//     has);
//   * ORs in the stash rows [hi, lo, vs_bits (W), vd_bits (W)] that match;
//   * picks the orientations: bits_f = fwd_canon ? vs : vd, bits_r =
//     palindrome ? vs : (fwd_canon ? vd : vs), both zero where !valid.
// Outputs are (B, P, W) int32, the layout of the reference's mono_probe.
//
// What bounds it: bytes. Each window reads its 15 bytes of hash, key and
// flags in order and writes 2W words (32 B at W = 4): 47 B a window, 141.7
// MB at the mono path's B = 32,768, P = 92, W = 4, or 42.3 us at 3.35 TB/s,
// plus the table rows it touches, each at most once (<= 21 MB there). The
// TPU kernel received the gathered rows from XLA, transposed to (RW, B, P)
// planes because Mosaic pads a size-S minor dimension to 128 lanes. Here the
// gather is fused, one thread per window, and the row never exists outside
// registers. What the design does about the L2 transactions that remain:
//   * the S hi and S lo words are one 32-byte sector at S = 4 (two 16-byte
//     loads);
//   * slot-major rows put the matched slot's 2W words in one contiguous
//     8W-byte run: one 32-byte sector at W = 4, loaded as two 16-byte
//     loads (the planar layout of the host table spread them over 4
//     sectors, W words S apart);
//   * each thread stores its W words of bits_f and of bits_r as 16-byte
//     stores when W % 4 == 0, so a warp's store covers 512 contiguous bytes
//     at W = 4 (scalar stores W words apart touched 4x the sectors);
//   * a thread requests all its window's inputs, then the key sector,
//     while the block copies its stash, then the matched slot's sector:
//     two dependent L2 round trips; invalid windows (N bases, read
//     padding) skip the row;
//   * the stash (at most MONO_MAX_STASH = 64 rows) is swept from shared
//     memory, each row's (hi, lo) compared with one 8-byte load.
//
// With every window invalid (no table reads) the kernel streams its inputs
// and outputs near the byte bound (kernel_bench.py times that case too);
// the two dependent L2 round trips of the valid windows are the rest.
//
// S comes from the row width and W is an argument, so a table of narrower
// buckets (S = 2, the reference's stacked layout) fits the same kernel.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxStash = 64;  // the stash-match mask is one 64-bit word
constexpr int kMaxSlots = 32;  // the slot-match mask is one 32-bit word
constexpr int kThreads = 256;

// vkeys: S == 4 and a 16-byte aligned table, so the keys take two 16-byte
// loads. vvals: vkeys, W % 4 == 0 and 16-byte aligned outputs, so the slot
// values and the stores take 16-byte accesses too.
template <bool vkeys, bool vvals>
__global__ void __launch_bounds__(kThreads)
mono_probe_kernel(const int32_t* __restrict__ bucket, int64_t nb2, int S,
                  int W, const int32_t* __restrict__ h1,
                  const int32_t* __restrict__ hi,
                  const int32_t* __restrict__ lo,
                  const uint8_t* __restrict__ fwd_canon,
                  const uint8_t* __restrict__ palindrome,
                  const uint8_t* __restrict__ valid, int64_t n,
                  const int32_t* __restrict__ stash, int n_stash,
                  int32_t* __restrict__ bits_f, int32_t* __restrict__ bits_r) {
  extern __shared__ int2 sh_stash2[];  // E is even: rows are 8-byte aligned
  int32_t* sh_stash = reinterpret_cast<int32_t*>(sh_stash2);
  const int E = 2 + 2 * W;  // words per slot entry and per stash row
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  // the window's inputs and the block's stash copy are requested together,
  // and the row's keys before the block waits for the copy
  bool ok = false, fc = false, pal = false;
  int32_t qhi = 0, qlo = 0;
  uint32_t h = 0;
  if (t < n) {
    ok = __ldg(valid + t) != 0;
    qhi = __ldg(hi + t);
    qlo = __ldg(lo + t);
    h = static_cast<uint32_t>(__ldg(h1 + t));
    fc = __ldg(fwd_canon + t) != 0;
    pal = __ldg(palindrome + t) != 0;
  }
  for (int i = threadIdx.x; i < n_stash * E; i += blockDim.x) {
    sh_stash[i] = stash[i];
  }
  // bit s: slot s holds the query key. An out-of-range hash reads no row.
  uint32_t slots = 0;
  const int32_t* row = bucket;
  if (ok && static_cast<int64_t>(h) < nb2) {
    row = bucket + static_cast<int64_t>(h) * S * E;  // 64-bit row offset
    if (vkeys) {
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
  __syncthreads();
  if (t >= n) return;
  int32_t* out_f = bits_f + t * W;
  int32_t* out_r = bits_r + t * W;
  if (!ok) {
    if (vvals) {
      const int4 z = make_int4(0, 0, 0, 0);
      for (int w = 0; w < W; w += 4) {
        *reinterpret_cast<int4*>(out_f + w) = z;
        *reinterpret_cast<int4*>(out_r + w) = z;
      }
    } else {
      for (int w = 0; w < W; ++w) {
        out_f[w] = 0;
        out_r[w] = 0;
      }
    }
    return;
  }
  uint64_t stashed = 0;  // bit r: stash row r holds the query key
  for (int r = 0; r < n_stash; ++r) {
    const int2 key = sh_stash2[r * (E / 2)];
    stashed |= static_cast<uint64_t>(key.x == qhi && key.y == qlo) << r;
  }

  const int32_t* vals = row + 2 * S;  // slot s: vals[2W s, 2W s + 2W)
  if (vvals) {
    for (int w = 0; w < W; w += 4) {
      int4 vs = make_int4(0, 0, 0, 0);
      int4 vd = vs;
      for (uint32_t m = slots; m != 0; m &= m - 1) {
        const int s = __ffs(static_cast<int>(m)) - 1;
        const int32_t* v = vals + 2 * W * s + w;
        const int4 a = __ldg(reinterpret_cast<const int4*>(v));
        const int4 d = __ldg(reinterpret_cast<const int4*>(v + W));
        vs.x |= a.x; vs.y |= a.y; vs.z |= a.z; vs.w |= a.w;
        vd.x |= d.x; vd.y |= d.y; vd.z |= d.z; vd.w |= d.w;
      }
      for (uint64_t m = stashed; m != 0; m &= m - 1) {
        const int r = __ffsll(static_cast<long long>(m)) - 1;
        const int32_t* v = sh_stash + r * E + 2 + w;
        vs.x |= v[0]; vs.y |= v[1]; vs.z |= v[2]; vs.w |= v[3];
        vd.x |= v[W]; vd.y |= v[W + 1]; vd.z |= v[W + 2]; vd.w |= v[W + 3];
      }
      *reinterpret_cast<int4*>(out_f + w) = fc ? vs : vd;
      *reinterpret_cast<int4*>(out_r + w) = pal ? vs : (fc ? vd : vs);
    }
    return;
  }
  for (int w = 0; w < W; ++w) {
    int32_t vs = 0;
    int32_t vd = 0;
    for (uint32_t m = slots; m != 0; m &= m - 1) {
      const int s = __ffs(static_cast<int>(m)) - 1;
      vs |= __ldg(vals + 2 * W * s + w);
      vd |= __ldg(vals + 2 * W * s + W + w);
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
// bucket (nb2, S * (2 + 2W)) int32, slot-major; h1, hi, lo (n,) int32;
// fwd_canon, palindrome, valid (n,) bytes; stash (n_stash, 2 + 2W) int32;
// bits_f and bits_r (n, W) int32. All contiguous.
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
  // With S = 4 every row (4 (2 + 2W) words) and its 8 key words start
  // 16-byte aligned when the table does; with W % 4 == 0 so do each slot's
  // 2W words, and each thread's W output words when the outputs do.
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vkeys = S == 4 && aligned(bucket);
  const bool vvals = vkeys && W % 4 == 0 && aligned(bits_f) && aligned(bits_r);
  const size_t smem = static_cast<size_t>(n_stash) * (2 + 2 * W) * sizeof(int32_t);
  const auto kernel = vvals ? mono_probe_kernel<true, true>
                      : vkeys ? mono_probe_kernel<true, false>
                              : mono_probe_kernel<false, false>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bucket), nb2, S, W,
      static_cast<const int32_t*>(h1), static_cast<const int32_t*>(hi),
      static_cast<const int32_t*>(lo), static_cast<const uint8_t*>(fwd_canon),
      static_cast<const uint8_t*>(palindrome),
      static_cast<const uint8_t*>(valid), n,
      static_cast<const int32_t*>(stash), n_stash,
      static_cast<int32_t*>(bits_f), static_cast<int32_t*>(bits_r));
  return static_cast<int>(cudaGetLastError());
}
