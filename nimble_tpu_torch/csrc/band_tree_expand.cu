// band_tree_expand: the banded intersection of the wide gband align step,
// for Hopper (sm_90a).
//
// Replaces nimble_tpu/align/kernels.py:band_tree_expand_pallas (body
// _band_tree_body) together with the band-row gather that
// nimble_tpu/align/engine.py:_score_mate_groupband runs before it. For every
// read r of a (B, Q1) batch of probe positions:
//   * for each position q with has[r, q], reads the half row
//     table[idx[r, q]] = [page | band (Wb = 2 Pw words)]: the pre-ANDed
//     class bitset of the position's g windows, stored as the aligned 2-page
//     window that starts at word page * Pw;
//   * ANDs those bands together: two bands whose pages differ by one
//     overlap in one page, a larger gap gives an empty set, and the result
//     lives in the frame of the higher page (engine.py:_band_combine);
//   * writes the (W,) int32 bitset: word w takes the band's lower half where
//     page == w / Pw, its upper half where page == w / Pw - 1, else 0; all
//     zero when no position contributed.
//
// The fold runs in position order. The reference folds in a halving tree;
// the result is the same bits, because every fold is the exact set
// intersection in a frame that holds it, and the final frame is the
// maximum page of the contributing positions in any order.
//
// What bounds it: bytes. At the 20k-allele library (W = 625, Pw = 32) each
// read reads up to Q1 (16 for 100 bp reads) rows of 260 B at random from a
// 62.5 MB table (mostly L2 hits) and writes 2.5 KB of bitset in order. The
// TPU kernel received the gathered rows from XLA in a (Q1, B, Wb + 2)
// layout padded to Mosaic's 128-lane tiles, 242 MB per 65,536-read chunk
// through device memory; here the rows never leave registers and shared
// memory. One warp
// per read: the lanes read the Q1 (idx, has) pairs 32 at a time and skip the
// positions without a contribution (ballot), every fold is a warp-wide
// pass over the read's Wb-word accumulator in shared memory (a page shift
// moves words across lanes), and the W output words are stored coalesced.
// Rows are 1 + Wb int32, an odd count, so they are read with scalar loads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // reads per block
constexpr unsigned kFull = 0xffffffffu;

__global__ void band_tree_expand_kernel(const int32_t* __restrict__ table,
                                        int64_t n_rows, int Pw,
                                        const int32_t* __restrict__ idx,
                                        const uint8_t* __restrict__ has,
                                        int64_t B, int Q1, int W,
                                        int32_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (r >= B) return;  // the whole warp leaves together
  const int Wb = 2 * Pw;
  const int64_t E = 1 + Wb;  // words per table row
  int32_t* acc = smem + warp * Wb;
  const int32_t* idx_r = idx + r * Q1;
  const uint8_t* has_r = has + r * Q1;

  bool any = false;  // warp-uniform: every lane reads the same rows
  int page = 0;
  for (int q0 = 0; q0 < Q1; q0 += 32) {
    const int q = q0 + lane;
    const bool h = q < Q1 && __ldg(has_r + q) != 0;
    int64_t i = h ? static_cast<int64_t>(__ldg(idx_r + q)) : 0;
    i = i < 0 ? 0 : (i >= n_rows ? n_rows - 1 : i);  // clamped, as a jnp gather
    for (unsigned m = __ballot_sync(kFull, h); m != 0; m &= m - 1) {
      const int src = __ffs(static_cast<int>(m)) - 1;
      const int64_t row_i = __shfl_sync(kFull, static_cast<long long>(i), src);
      const int32_t* row = table + row_i * E;  // 64-bit row offset
      const int p2 = __ldg(row);
      const int32_t* b2 = row + 1;
      if (!any) {
        for (int j = lane; j < Wb; j += 32) acc[j] = __ldg(b2 + j);
        page = p2;
        any = true;
      } else {
        const int d = p2 - page;
        if (d == 0) {
          for (int j = lane; j < Wb; j += 32) acc[j] &= __ldg(b2 + j);
        } else if (d == 1) {
          // the accumulator's upper page meets the new band's lower page:
          // move it down, then clear the upper page
          for (int j = lane; j < Pw; j += 32) acc[j] = acc[j + Pw] & __ldg(b2 + j);
          __syncwarp();
          for (int j = Pw + lane; j < Wb; j += 32) acc[j] = 0;
        } else if (d == -1) {
          for (int j = lane; j < Pw; j += 32) acc[j] &= __ldg(b2 + Pw + j);
          for (int j = Pw + lane; j < Wb; j += 32) acc[j] = 0;
        } else {
          for (int j = lane; j < Wb; j += 32) acc[j] = 0;
        }
        page = page > p2 ? page : p2;
      }
      __syncwarp();
    }
  }

  int32_t* out_r = out + r * W;
  for (int w = lane; w < W; w += 32) {
    int32_t v = 0;
    if (any) {
      const int pw = w / Pw;
      const int off = w - pw * Pw;
      if (page == pw) {
        v = acc[off];
      } else if (page == pw - 1) {
        v = acc[Pw + off];
      }
    }
    out_r[w] = v;
  }
}

}  // namespace

// The library links its own CUDA runtime, whose current device is not
// PyTorch's: the caller names the device of its tensors and stream.
// table (n_rows, 1 + 2 Pw) int32; idx (B, Q1) int32; has (B, Q1) bytes;
// out (B, W) int32. All contiguous.
extern "C" int nt_band_tree_expand(int device, const void* table,
                                   int64_t n_rows, int Pw, const void* idx,
                                   const void* has, int64_t B, int Q1, int W,
                                   void* out, void* stream) {
  if (n_rows < 1 || Pw < 1 || Q1 < 0 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(kWarps) * 2 * Pw * sizeof(int32_t);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(band_tree_expand_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (B + kWarps - 1) / kWarps;
  band_tree_expand_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), n_rows, Pw,
      static_cast<const int32_t*>(idx), static_cast<const uint8_t*>(has), B,
      Q1, W, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
