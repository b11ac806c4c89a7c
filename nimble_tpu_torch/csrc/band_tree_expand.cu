// band_tree_expand: the banded intersection of the wide gband align step,
// for Hopper (sm_90a).
//
// Replaces nimble_tpu/align/kernels.py:band_tree_expand_pallas (body
// _band_tree_body) together with the band-row gather that
// nimble_tpu/align/engine.py:_score_mate_groupband runs before it. For every
// read r of a (B, Q1) batch of probe positions, each position q with
// has[r, q] names a row of the gband table: a page and a band of 2 Pw words,
// the class bitset of the position's g windows stored as the aligned 2-page
// window that starts at word page * Pw. The result is the AND of those sets,
// expanded to W words. The table comes re-laid on the card
// (align/tables.py:relayout_gband): a page vector and 256-byte band rows
// (at Pw = 32), so that a warp's 32 words of a row are 4 whole sectors, not
// the 5 that the reference's odd [page | band] rows of 260 B straddle.
//
// The reference folds the bands in a halving tree, each fold the exact set
// intersection framed at the higher page (engine.py:_band_combine). That
// fold has a closed form, which this kernel computes instead. With H the
// positions that contribute (indices clamped into the table, as a jnp gather
// clamps them), P the highest and m the lowest page over H:
//   * H empty, P - m >= 2, or P outside [0, ceil(W / Pw)): all W words 0;
//   * m == P: words [P Pw, P Pw + 2 Pw), cut at W, take the AND of the full
//     bands;
//   * m == P - 1: words [P Pw, P Pw + Pw) take the AND of the lower halves
//     of the rows at page P with the upper halves of the rows at page P - 1;
//     the rest is 0.
// tests/test_torch_gband.py:two_pass models this against the tree.
//
// What bounds it: bytes. At the 20k-allele library (W = 625, Pw = 32, 100 bp
// reads: B = 32,768, Q1 = 16) a call writes 82 MB of bitset, almost all
// zero, and reads ~96k distinct rows (25 MB), each ~4.5 times, from a 62.5 MB
// table. One warp per read, in three passes:
//   1. page pass: the lanes take the read's (idx, has) 32 positions at a
//      time and every contributing lane loads its row's page at once, so a
//      read's page loads are one round trip, not one per position; ballot
//      and warp min/max give H, P and m. An empty H or a gap of 2 reads no
//      band word.
//   2. store pass: the words outside the frame [P Pw, P Pw + n) are zero and
//      are stored at once, decided by offset compares (no division): 16-byte
//      stores where four words are aligned and all outside the frame, 4-byte
//      ones at the row's ends and around the frame's edges. Every store is
//      streaming (st.global.cs), so that the output does not push out of L2
//      the band rows that later reads share.
//   3. band pass: each lane owns words of the frame and loads them from up
//      to 8 rows at a time with independent loads (half rows when
//      m == P - 1), ANDs them in registers and stores its frame words. No
//      shared memory and no per-position synchronisation.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // reads per block
constexpr int kBatch = 8;  // rows whose words a lane loads together
constexpr unsigned kFull = 0xffffffffu;

// Where the rows lie: row i's page at pages[i * page_stride], its band at
// bands[i * band_stride ...] (the page vector and the band rows here).
struct Rows {
  const int32_t* __restrict__ pages;
  const int32_t* __restrict__ bands;
  int64_t page_stride, band_stride, n_rows;
};

// Position q of a read: whether it contributes, its row's first band word
// (64-bit offset into bands) and its row's page.
struct Pos {
  bool has;
  int64_t row;
  int page;
};

__device__ __forceinline__ Pos load_pos(const Rows& t, const int32_t* __restrict__ idx_r,
                                        const uint8_t* __restrict__ has_r, int q, int Q1) {
  Pos s{false, 0, 0};
  if (q < Q1 && __ldg(has_r + q) != 0) {
    int64_t i = __ldg(idx_r + q);
    i = i < 0 ? 0 : (i >= t.n_rows ? t.n_rows - 1 : i);  // clamped, as a jnp gather
    s.has = true;
    s.row = i * t.band_stride;
    s.page = __ldg(t.pages + i * t.page_stride);
  }
  return s;
}

// Zeros for the words of a read's row outside its frame [f0, f0 + nf).
__device__ __forceinline__ void store_outside(int32_t* out_r, int W, int f0, int nf, int lane) {
  // h words up to the first 16-byte boundary, nv aligned groups of 4, a tail
  const int h = min(W, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(out_r) & 15)) & 15) >> 2);
  const int nv = (W - h) >> 2;
  const int t0 = h + 4 * nv;
  if (lane < h && static_cast<unsigned>(lane - f0) >= static_cast<unsigned>(nf)) __stcs(out_r + lane, 0);
  const int t = t0 + lane;
  if (t < W && static_cast<unsigned>(t - f0) >= static_cast<unsigned>(nf)) __stcs(out_r + t, 0);
  int4* v = reinterpret_cast<int4*>(out_r + h);
  for (int i = lane; i < nv; i += 32) {
    const int w = h + 4 * i;
    if (w + 4 <= f0 || w >= f0 + nf) {
      __stcs(v + i, make_int4(0, 0, 0, 0));
    } else {  // the frame's edge: only the words outside it
      for (int k = 0; k < 4; ++k) {
        if (static_cast<unsigned>(w + k - f0) >= static_cast<unsigned>(nf)) __stcs(out_r + w + k, 0);
      }
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
band_tree_expand_kernel(const Rows t, int Pw, int n_pages,
                        const int32_t* __restrict__ idx,
                        const uint8_t* __restrict__ has, int64_t B, int Q1,
                        int W, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (r >= B) return;  // the whole warp leaves together
  const int32_t* idx_r = idx + r * Q1;
  const uint8_t* has_r = has + r * Q1;

  // 1. page pass; the first 32 positions stay in registers for the band pass
  const Pos first = load_pos(t, idx_r, has_r, lane, Q1);
  bool any = false;
  int P = INT_MIN, m = INT_MAX;
  for (int q0 = 0; q0 < Q1; q0 += 32) {
    const Pos s = q0 == 0 ? first : load_pos(t, idx_r, has_r, q0 + lane, Q1);
    if (__ballot_sync(kFull, s.has) != 0) {
      any = true;
      P = max(P, __reduce_max_sync(kFull, s.has ? s.page : INT_MIN));
      m = min(m, __reduce_min_sync(kFull, s.has ? s.page : INT_MAX));
    }
  }
  // the frame: output words [f0, f0 + nf) come from the band pass
  int f0 = 0, nf = 0;
  if (any && P >= 0 && P < n_pages && m >= P - 1) {
    f0 = P * Pw;
    nf = min(m == P ? 2 * Pw : Pw, W - f0);
  }

  // 2. zeros outside the frame
  int32_t* out_r = out + r * W;
  store_outside(out_r, W, f0, nf, lane);

  // 3. band pass: lane owns frame words j0 + lane and j0 + lane + 32
  for (int j0 = 0; j0 < nf; j0 += 64) {
    const int ja = j0 + lane, jb = ja + 32;
    int a = -1, b = -1;
    for (int q0 = 0; q0 < Q1; q0 += 32) {
      const Pos s = q0 == 0 ? first : load_pos(t, idx_r, has_r, q0 + lane, Q1);
      // a row one page below P gives its upper half
      const long long base = s.row + (s.page < P ? Pw : 0);
      for (unsigned mask = __ballot_sync(kFull, s.has); mask != 0;) {
        long long rows[kBatch];
        bool ok[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {  // warp-uniform: every lane walks the same rows
          ok[k] = mask != 0;
          rows[k] = __shfl_sync(kFull, base, (__ffs(static_cast<int>(mask)) - 1) & 31);
          mask &= mask - 1;
        }
        int va[kBatch], vb[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          va[k] = ok[k] && ja < nf ? __ldg(t.bands + rows[k] + ja) : -1;
          vb[k] = ok[k] && jb < nf ? __ldg(t.bands + rows[k] + jb) : -1;
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          a &= va[k];
          b &= vb[k];
        }
      }
    }
    if (ja < nf) __stcs(out_r + f0 + ja, a);
    if (jb < nf) __stcs(out_r + f0 + jb, b);
  }
}

int launch(int device, const Rows& t, int Pw, const void* idx, const void* has,
           int64_t B, int Q1, int W, void* out, void* stream) {
  if (t.n_rows < 1 || Pw < 1 || Q1 < 0 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (B + kWarps - 1) / kWarps;
  band_tree_expand_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      t, Pw, (W + Pw - 1) / Pw, static_cast<const int32_t*>(idx),
      static_cast<const uint8_t*>(has), B, Q1, W, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The library links its own CUDA runtime, whose current device is not
// PyTorch's: the caller names the device of its tensors and stream.
// pages (n_rows,) int32; bands (n_rows, 2 Pw) int32; idx (B, Q1) int32;
// has (B, Q1) bytes; out (B, W) int32. All contiguous.
extern "C" int nt_band_tree_expand(int device, const void* pages, const void* bands,
                                   int64_t n_rows, int Pw, const void* idx,
                                   const void* has, int64_t B, int Q1, int W,
                                   void* out, void* stream) {
  const Rows t{static_cast<const int32_t*>(pages), static_cast<const int32_t*>(bands), 1,
               2 * static_cast<int64_t>(Pw), n_rows};
  return launch(device, t, Pw, idx, has, B, Q1, W, out, stream);
}
