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
// What bounds it: the row sectors a read still needs. A read ANDs 60-65 rows
// (one per run of its ~95 positions), but after its first row only the words
// still set in its running AND can change the answer: AND with a zero word
// is zero whatever the row holds. In a real library a read's features sit in
// a few words (its family's), so most of each later row is dead. The bytes
// that must move are the ids and flags (5 B a position), the (B, W) output
// and the 32-byte sectors of those still-set words, each distinct (class,
// sector) once; they come out of L2 at W = 157 (a 36 MB table) and out of
// HBM at W = 625 (579 MB). Reading whole rows, as the kernel before this one
// did, fetched every word of every run's row. One warp per read, in two
// passes:
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
//   2. rows, around an active list of the words still set: the first run's
//      row is loaded whole into the warp's accumulator (shared memory), and
//      the indices of its nonzero words are compacted, in order, into the
//      active list (ballot and popcount, as the runs are). Each later group
//      of kUnroll runs walks the list 32 entries at a time: a lane loads its
//      listed word of each of the group's rows at once (kUnroll loads in
//      flight, a 64-bit row offset), ANDs them into the accumulator, and
//      the words that stayed nonzero are compacted again, in place. Lanes
//      next to each other take listed words next to each other, so the
//      sectors they fetch are whole where the live words are contiguous.
//      Words that leave the list hold zero in the accumulator. The warp
//      leaves the read as soon as the list is empty, then stores the
//      accumulator, coalesced: the whole output row.
// A row wider than shared memory allows (never at the widths the engine
// makes: W up to ~38,000 words fits whole beside P = 1) is walked in tiles
// of words, each tile with its own first row, list and early exit.
// No host sync and no allocation: a CUDA graph can replay it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // reads per block, fewer where shared memory needs it
constexpr int kUnroll = 8;  // runs whose listed words a lane loads together
constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kMaxTile = 65536;  // list entries are 16-bit word indices

__global__ void __launch_bounds__(kWarps * 32)
intersect_class_bits_kernel(const int32_t* __restrict__ ids, const uint8_t* __restrict__ matched,
                            int64_t B, int P, const int32_t* __restrict__ bits, int64_t C, int W,
                            int tile, int warps, int32_t* __restrict__ out) {
  // [warps run lists of P classes][warps accumulators of `tile` words]
  // [warps active lists of `tile` word indices]
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * warps + warp;
  if (r >= B) return;  // the whole warp leaves together
  int32_t* runs = smem + static_cast<int64_t>(warp) * P;
  int32_t* acc = smem + static_cast<int64_t>(warps) * P + static_cast<int64_t>(warp) * tile;
  uint16_t* live = reinterpret_cast<uint16_t*>(smem + static_cast<int64_t>(warps) * (P + tile)) +
                   static_cast<int64_t>(warp) * tile;
  const int32_t* ids_r = ids + r * P;
  const uint8_t* matched_r = matched + r * P;
  int32_t* out_r = out + r * W;
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
  if (n == 0) {  // no row to AND: all ones if a position matched, else zero
    for (int w = lane; w < W; w += 32) out_r[w] = any ? -1 : 0;
    return;
  }

  // 2. rows, one tile of words at a time (one tile unless W is very wide)
  for (int t0 = 0; t0 < W; t0 += tile) {
    const int tw = min(tile, W - t0);
    const int32_t* base = bits + t0;
    const int32_t* first = base + static_cast<int64_t>(runs[0]) * W;
    int m = 0;  // the active list's length
    for (int w0 = 0; w0 < tw; w0 += 32) {
      const int w = w0 + lane;
      const int v = w < tw ? __ldg(first + w) : 0;
      if (w < tw) acc[w] = v;
      const unsigned set = __ballot_sync(kFull, v != 0);
      if (v != 0) live[m + __popc(set & below)] = static_cast<uint16_t>(w);
      m += __popc(set);
    }
    __syncwarp();
    for (int i = 1; i < n && m > 0; i += kUnroll) {
      const int32_t* rows[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        rows[k] = i + k < n ? base + static_cast<int64_t>(runs[i + k]) * W : nullptr;
      }
      int kept = 0;
      for (int j0 = 0; j0 < m; j0 += 32) {
        const int j = j0 + lane;
        int w = 0;
        int a = 0;
        if (j < m) {
          w = live[j];
          int v[kUnroll];
#pragma unroll
          for (int k = 0; k < kUnroll; ++k) v[k] = rows[k] != nullptr ? __ldg(rows[k] + w) : -1;
          a = acc[w];
#pragma unroll
          for (int k = 0; k < kUnroll; ++k) a &= v[k];
          acc[w] = a;
        }
        // in place: a kept entry moves to kept + rank <= j, an entry this
        // chunk's lanes have read before the ballot, or an earlier chunk's
        const unsigned keep = __ballot_sync(kFull, a != 0);
        if (a != 0) live[kept + __popc(keep & below)] = static_cast<uint16_t>(w);
        kept += __popc(keep);
      }
      m = kept;
      __syncwarp();
    }
    for (int w = lane; w < tw; w += 32) out_r[t0 + w] = acc[w];
    __syncwarp();  // the next tile reuses the accumulator
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
  // a warp holds its run list (4 B a position) and, for each word of a
  // tile, its accumulator word (4 B) and list entry (2 B): the whole row
  // where it fits beside the run list, else the widest tile that does
  const int64_t list = 4 * static_cast<int64_t>(P);
  const int64_t per_word = 6;
  if (list + per_word > smem_max) return static_cast<int>(cudaErrorInvalidValue);
  int64_t tile = W;
  if (list + per_word * tile > smem_max) tile = (smem_max - list) / per_word;
  if (tile > kMaxTile) tile = kMaxTile;
  const int64_t per_warp = list + per_word * tile;
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
      static_cast<const int32_t*>(bits), C, W, static_cast<int>(tile), warps, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
