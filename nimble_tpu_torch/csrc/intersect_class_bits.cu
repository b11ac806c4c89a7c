// intersect_class_bits: the class-bits intersection of the class-id align
// steps (groupcls, monocls, the wide two-choice probe), for Hopper (sm_90a).
//
// Replaces nimble_tpu/align/engine.py:intersect_class_bits, which the
// reference leaves to XLA (no pallas_call): for W <= 32 one (B, P, W) row
// gather and an AND tree, for W > 32 the runs-compacted while_loop that
// gathers RUN_BLOCK run-start classes a trip and stops after
// ceil(max_runs / RUN_BLOCK) trips. For every read r of a (B, P) batch the
// result is the AND of class_bits' rows at the read's matched positions:
// unmatched positions contribute all ones, and a read with no matched
// position ends all-zero. AND is idempotent, so one row per run of equal
// consecutive classes gives the same bits.
//
// The reference's two branches differ on one input the engine never makes
// (it passes matched = ids >= 0): a matched position with a negative id ANDs
// row 0 for W <= 32 (the gather of clip(ids, 0)) and all ones for W > 32
// (the run's slot holds -1). This kernel follows both. Ids past the table
// are clamped to its last row, as a jnp gather clamps them.
//
// What bounds it: bytes. A call must read the ids and flags (5 B a
// position), write the (B, W) bits and read each distinct class row once;
// at W = 157, B = 65,536, P = 92 that is ~30 MB + 41 MB + the rows. The
// rows a read ANDs come again and again from L2 (a few runs a read over a
// few thousand hot classes). One warp per read, in two passes:
//   1. runs: the lanes take the read's ids and flags 32 positions at a time,
//      coalesced; a position's class is its id where matched (row 0 or -1
//      for a negative id, by the branch above), -1 where not; `prev` is the
//      lane below's class (__shfl_up_sync), the segment's first lane takes
//      the previous segment's last class, the first position -2. A run
//      starts where the class is a row (>= 0) and differs from prev, the
//      reference's rule; __ballot_sync makes the starts a mask, and the
//      run-start classes are compacted, in order, into the warp's list in
//      shared memory (at most P entries, sized from P at launch). The read
//      stops at its own run count: the reference's while_loop per read, not
//      per chunk, and no count ever reaches the host.
//   2. rows: each lane owns the words w = lane, lane + 32, ... < W and ANDs
//      class_bits[run * W + w] over the read's runs, four runs at a time so
//      that four rows' loads are in flight (the last group padded with all
//      ones), with a 64-bit row offset; a warp's loads of one row are
//      contiguous words. Then it stores its words, coalesced.
// No host sync and no allocation: a CUDA graph can replay it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // reads per block, fewer where P's run lists need it
constexpr int kUnroll = 4;  // runs whose rows a lane loads together
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
intersect_class_bits_kernel(const int32_t* __restrict__ ids, const uint8_t* __restrict__ matched,
                            int64_t B, int P, const int32_t* __restrict__ bits, int64_t C, int W,
                            int warps, int32_t* __restrict__ out) {
  extern __shared__ int32_t run_lists[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * warps + warp;
  if (r >= B) return;  // the whole warp leaves together
  int32_t* runs = run_lists + static_cast<int64_t>(warp) * P;
  const int32_t* ids_r = ids + r * P;
  const uint8_t* matched_r = matched + r * P;
  const int negative = W <= 32 ? 0 : -1;  // the class of a matched negative id
  const unsigned below = (1u << lane) - 1u;

  // 1. runs
  int n = 0;
  bool any = false;
  int carry = -2;
  for (int q0 = 0; q0 < P; q0 += 32) {
    const int q = q0 + lane;
    bool m = false;
    int cls = -1;
    if (q < P && __ldg(matched_r + q) != 0) {
      m = true;
      const int id = __ldg(ids_r + q);
      cls = id < 0 ? negative : (id >= C ? static_cast<int>(C - 1) : id);
    }
    int prev = __shfl_up_sync(kFull, cls, 1);
    if (lane == 0) prev = carry;
    carry = __shfl_sync(kFull, cls, 31);
    const bool start = cls >= 0 && cls != prev;
    const unsigned starts = __ballot_sync(kFull, start);
    any |= __ballot_sync(kFull, m) != 0;
    if (start) runs[n + __popc(starts & below)] = cls;
    n += __popc(starts);
  }
  __syncwarp();

  // 2. rows
  int32_t* out_r = out + r * W;
  for (int w = lane; w < W; w += 32) {
    int acc = -1;
    for (int i = 0; i < n; i += kUnroll) {
      int v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        v[k] = i + k < n ? __ldg(bits + static_cast<int64_t>(runs[i + k]) * W + w) : -1;
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) acc &= v[k];
    }
    out_r[w] = any ? acc : 0;
  }
}

}  // namespace

// The library links its own CUDA runtime, whose current device is not
// PyTorch's: the caller names the device of its tensors and stream.
// ids (B, P) int32; matched (B, P) bytes; bits (C, W) int32; out (B, W)
// int32. All contiguous.
extern "C" int nt_intersect_class_bits(int device, const void* ids, const void* matched, int64_t B,
                                       int P, const void* bits, int64_t C, int W, void* out,
                                       void* stream) {
  if (P < 1 || C < 1 || W < 1 || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int smem_max = 0;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one run list of P classes a warp
  const int64_t per_warp = 4 * static_cast<int64_t>(P);
  if (per_warp > smem_max) return static_cast<int>(cudaErrorInvalidValue);
  const int warps = static_cast<int>(per_warp * kWarps <= smem_max ? kWarps : smem_max / per_warp);
  const size_t smem = static_cast<size_t>(per_warp * warps);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(intersect_class_bits_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (B + warps - 1) / warps;
  intersect_class_bits_kernel<<<static_cast<unsigned>(blocks), warps * 32, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const uint8_t*>(matched), B, P,
      static_cast<const int32_t*>(bits), C, W, warps, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
