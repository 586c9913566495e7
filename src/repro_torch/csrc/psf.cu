// Hopper (sm_90a) kernels of PSF matching: each scanned frame correlated
// with its own slot's matching kernel, edge-clamped, before the warp.
//
// Replaces the convolution prologue of the Pallas TPU kernels in
// src/repro/kernels/warp/warp.py:
//   _coadd_fused_psf_kernel   (:301, _convolve_sep_matmul) -> psf_match_sep_kernel
//   _coadd_fused_psf2d_kernel (:337, _convolve_2d_matmul)  -> psf_match_2d_kernel
// and the same prologue of coadd_moments / coadd_clip / coadd_hist with
// psf_mode "sep" or "2d" (_warped_sample, :482).  The TPU builds banded
// one-hot matrices because it has no gather unit, and re-runs the
// convolution on every (row block, image) grid step.  Here the convolution
// is a pre-pass, run once per query: one launch writes the matched pixels of
// the query's scanned packs to a (G, cap, H, W) scratch, and every pass of
// the query (pack_scan_kernel in csrc/warp.cu) scans that scratch.  Fusing
// it into warp_sample would convolve 4 neighbours per sample (~1,350
// operations for a 13 x 13 kernel against the warp's ~51); the pre-pass
// convolves each source pixel once.
//
// Only the slots a pass reads are matched.  `skip` (a (G, cap) uint8 flag,
// or null for none) marks scratch images whose blocks write zeros and read
// neither taps nor pixels: the engine sets it for rejected slots whose
// matched flag is set (ops.matched_finite), which the culled pack scans
// never read (rule (a) of csrc/warp.cu); the unculled check form reads 0 * 0
// = +0 there where it read (finite) * 0 = +-0, the same sums.
//
// Both kernels stage an output tile plus its halo in shared memory, with
// source addresses clamped to the image edges (so an image narrower than the
// kernel clamps on both sides at once), and read the slot's taps into shared
// memory; 256 threads a block, and flat offsets 64-bit.  The 2-D kernel runs
// one block per (tile, image), the separable one a block per tile that
// walks images (below).
//
// Arithmetic, in the order of the plain torch versions
// (repro_torch.core.psf), with every product and sum rounded on its own
// (-fmad=false, no fast math):
//   separable, (P, cap, K) bank: a row pass along W over the tile's rows and
//     halo rows, then a column pass along H, each sum_{m=0..K-1} t[m] * x
//     from 0, as _convolve_sep_matmul does (image @ m_w.T, then m_h @ .).
//     K == 1 is one multiply, as convolve_batch short-circuits it.
//   2-D, (P, cap, Kh, Kw) bank: for each kernel row m a sum over n from 0,
//     added to the output in order m = 0..Kh-1, as _convolve_2d_matmul adds
//     its Kh banded-matmul pairs.  Kw == 1 is one multiply by k[0, 0].
// Both kernels are register-blocked: a thread owns a block of outputs and
// walks its window in ascending order, so blocking reorders work across
// outputs and never within one, and each result is bitwise its plain
// version's.
//
// What bounds them on an H100.  Each source pixel is read once and each
// matched pixel written once (8 bytes); a 13 x 13 kernel costs 338 fp32
// operations a pixel (a 15-tap separable one 60), against 67 TFLOP/s, so the
// 2-D kernel is bounded by operations and the separable one by bytes
// (3.35 TB/s).  Since no product may fuse with its sum, a tap is an FMUL and
// an FADD: the 2-D kernel cannot beat twice its operation bound, and the
// separable one's FP32 work (with its halo rows, ~67 instructions a pixel at
// K = 15) is close to its byte bound.
//
// psf_match_sep_kernel: a 64 x 64 tile.  With loads of a tap and a pixel
// from shared memory for each multiply and add, the kernel would be bounded
// by shared-memory loads, so:
//   row pass: an item is one window row and 4 consecutive columns (so a
//     quarter warp reads 32 consecutive floats, free of bank conflicts, and
//     the items fill the block's threads evenly); the thread loads the
//     pixels 4 + 4 at a time into registers (16-byte loads) and writes 4 row
//     sums to the staged `mid` rows;
//   column pass: a thread owns 4 x 4 outputs, walks the 4 + K - 1 `mid`
//     rows of its 4 columns in ascending order (one 16-byte load each), and
//     adds each into the outputs it feeds;
// a tap is one broadcast load from shared memory, reused over 4 outputs.
// Any K up to MAX_TAPS (49), and K == 1 as one multiply.  Staging a window
// and then computing on it, block by block, leaves the card waiting on
// memory for most of each block's life; so each block keeps its tile and
// walks images (as many blocks as fit on the card at once), and starts
// copying the next image's window (cp.async) as soon as its row pass has
// read this one, so the copy overlaps the column pass and the stores.  One
// window buffer, not two: 47 KB at K = 15 fits four blocks an SM where two
// buffers fit three, which was slower on an H100.
//
// psf_match_2d_kernel is register-blocked, so that it is bounded by the FP32
// pipe and not by shared-memory loads (a tap and a pixel loaded from shared
// memory for each multiply and add would be).  Each of 16 x 16
// threads owns an R x C block of outputs (a 16 R x 16 C tile), and walks the
// staged window rows in ascending order.  For each window row it loads the
// C + Kw - 1 pixels its columns need into registers once (16-byte loads), and
// for each of its output rows that the window row feeds, that kernel row's
// taps once (16-byte broadcast loads), reused over its C columns.  Two paths:
//   fixed width (Kw == kFixedKw, 13: SurveyConfig.psf_stamp_size's default,
//     so the width of every measured bank), 4 x 8: the whole window row and
//     tap row in registers, every loop unrolled;
//   any width, 2 x 8: taps in groups of 4, C + 3 pixels a group.
// chip_smoke.py phase 5 times both paths on one 13 x 13 bank (the any-width
// one through psf_match_2d_any_f32); PERF.md records the two.
// Window rows that feed all R output rows run without a test per row.  The
// window is staged in 16-byte loads aligned in the image (clamped element by
// element at the edges, or throughout when W is not a multiple of 4), rows
// of taps padded to a multiple of 4 with zeros that are never read into a
// sum.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;      // both kernels

// The slot an image of the scratch comes from: pack pack_idx[g], slot s.
__device__ __forceinline__ int64_t source_slot(const int* __restrict__ pack_idx, int img,
                                               int cap) {
  return static_cast<int64_t>(pack_idx[img / cap]) * cap + img % cap;
}

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Window rows: smem (yy, s) <- image (clamp(y0 - rh + yy), clamp(xs + s)),
// one warp a row.  Image columns are read in 16-byte groups aligned in the
// image (`vec`: W a multiple of 4 and a 16-byte aligned base), each group
// element by element where it crosses an edge.
__device__ __forceinline__ void stage_rows(float* __restrict__ dst, int ld,
                                           const float* __restrict__ im, int h, int w, int y0,
                                           int rh, int xs, int sh, int sw, bool vec, int tid) {
  const int lane = tid & 31;
  const int xa = xs & ~3;                      // floor to a multiple of 4
  const int groups = (xs + sw - xa + 3) >> 2;
  for (int yy = tid >> 5; yy < sh; yy += kThreads / 32) {
    const int gy = min(max(y0 - rh + yy, 0), h - 1);
    const float* row = im + static_cast<int64_t>(gy) * w;
    float* out = dst + yy * ld;
    for (int gi = lane; gi < groups; gi += 32) {
      const int gx = xa + 4 * gi;
      float x[4];
      if (vec && gx >= 0 && gx + 3 < w) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(row + gx));
        x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[e] = __ldg(row + min(max(gx + e, 0), w - 1));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int sx = gx + e - xs;
        if (sx >= 0 && sx < sw) out[sx] = x[e];
      }
    }
  }
}

// ---- separable: register-blocked, the next window copied early ---------

constexpr int kSepTile = 64;                   // output tile edge (rows and columns)
constexpr int kRowC = 4;                       // row pass: 4 row sums an item
constexpr int kColR = 4;                       // column pass: 4 x 4 outputs a thread
constexpr int kColC = 4;
static_assert(kSepTile / kColR * (kSepTile / kColC) == kThreads, "one 4 x 4 block a thread");

// A staged window row starts at the 16-byte group that holds its first
// column, x0 - r rounded down to a multiple of 4 (x0 is one, so the window
// starts `sep_off(r)` floats into its row), so that every group is one
// 16-byte copy.  Rows of sep_ld(k) floats: the row pass reads up to 7
// floats past the last column it sums, never into a sum.
__host__ __device__ constexpr int sep_off(int r) { return (4 - r % 4) % 4; }
__host__ __device__ constexpr int sep_ld(int k) { return round4(kSepTile + k + 7); }
// Shared floats of psf_match_sep_kernel at k taps: two buffers of taps
// (round4(k) each; the column pass still reads this image's while the next
// image's arrive), the window (64 + k - 1 rows of sep_ld(k)) and
// the row sums (64 + k - 1 rows of 64).
constexpr int sep_smem_floats(int k) {
  return 2 * round4(k) + (kSepTile + k - 1) * (sep_ld(k) + kSepTile);
}

__device__ __forceinline__ void cp_async(float* dst, const float* src, bool wide) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (wide)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
// Every copy this thread started is complete.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying image `src`'s taps and (64 + k - 1)-square window, clamped to
// its edges, into a taps buffer and the window: window row yy, float s <- image (clamp(y0 - r
// + yy), clamp(xa + s)) with xa = x0 - r - sep_off(r).  A group of 4 inside
// the image (`vec`) is one 16-byte copy, one that crosses an edge four
// 4-byte copies of clamped addresses.
__device__ __forceinline__ void stage_async(float* __restrict__ taps, float* __restrict__ win,
                                            const float* __restrict__ bank,
                                            const float* __restrict__ im, int64_t src, int h,
                                            int w, int k, int y0, int x0, bool vec, int tid) {
  const int r = (k - 1) / 2;
  const int ld = sep_ld(k);
  const int sh = kSepTile + k - 1;
  const int xa = x0 - r - sep_off(r);
  const int groups = (sep_off(r) + sh + 3) >> 2;   // 16-byte groups a window row
  for (int i = tid; i < k; i += kThreads) cp_async(taps + i, bank + src * k + i, false);
  for (int item = tid; item < sh * groups; item += kThreads) {
    const int yy = item / groups;
    const int g4 = 4 * (item - yy * groups);
    const int gx = xa + g4;
    const float* row = im + static_cast<int64_t>(min(max(y0 - r + yy, 0), h - 1)) * w;
    float* dst = win + yy * ld + g4;
    if (vec && gx >= 0 && gx + 3 < w) {
      cp_async(dst, row + gx, true);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) cp_async(dst + e, row + min(max(gx + e, 0), w - 1), false);
    }
  }
}

// Row pass of one item: the 4 row sums from window row `xw` (the staged
// row's group that holds its first column, `off` floats before it), taps
// in ascending m from 0, the pixels 4 + 4 at a time.
__device__ __forceinline__ void row_sums(float (&acc)[kRowC], const float* __restrict__ xw,
                                         const float* __restrict__ taps, int k, int off) {
#pragma unroll
  for (int c = 0; c < kRowC; ++c) acc[c] = 0.0f;
  for (int n0 = 0; n0 < k + off; n0 += 4) {
    float x[kRowC + 4];
#pragma unroll
    for (int i = 0; i < kRowC + 4; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(xw + n0 + i);
      x[i] = v.x, x[i + 1] = v.y, x[i + 2] = v.z, x[i + 3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = n0 + j - off;
      if (m < 0 || m >= k) continue;
      const float tm = taps[m];
#pragma unroll
      for (int c = 0; c < kRowC; ++c) acc[c] = acc[c] + tm * x[c + j];
    }
  }
}

// Column pass of one thread: its 4 x 4 outputs from the row sums `col` (its
// first column in `mid` row 0 of its block), mid rows in ascending order, so
// each output adds its taps in ascending m from 0.
__device__ __forceinline__ void column_sums(float (&acc)[kColR][kColC],
                                            const float* __restrict__ col,
                                            const float* __restrict__ taps, int k) {
#pragma unroll
  for (int r = 0; r < kColR; ++r)
#pragma unroll
    for (int c = 0; c < kColC; ++c) acc[r][c] = 0.0f;
  for (int wr = 0; wr < kColR + k - 1; ++wr) {
    const float4 v = *reinterpret_cast<const float4*>(col + wr * kSepTile);
    const float x[kColC] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int r = 0; r < kColR; ++r) {
      const int m = wr - r;
      if (m < 0 || m >= k) continue;
      const float tm = taps[m];
#pragma unroll
      for (int c = 0; c < kColC; ++c) acc[r][c] = acc[r][c] + tm * x[c];
    }
  }
}

// The thread's 4 x 4 outputs at (gy, gx) of image `dst`, inside (h, w).
__device__ __forceinline__ void store_block(float* __restrict__ dst,
                                            const float (&acc)[kColR][kColC], int gy, int gx,
                                            int h, int w, bool vec) {
  if (gx >= w) return;
#pragma unroll
  for (int r = 0; r < kColR; ++r) {
    if (gy + r >= h) return;
    float* o = dst + static_cast<int64_t>(gy + r) * w + gx;
    if (vec && gx + kColC <= w) {
      *reinterpret_cast<float4*>(o) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
#pragma unroll
      for (int c = 0; c < kColC; ++c)
        if (gx + c < w) o[c] = acc[r][c];
    }
  }
}

// Each block keeps its 64 x 64 tile and walks the images blockIdx.z,
// blockIdx.z + gridDim.z, ... (the grid fits the card at once), copying the
// next image's window once every thread has read this one's.  A skipped
// image is neither copied nor matched: its tile is zeros.
__global__ void __launch_bounds__(kThreads)
    psf_match_sep_kernel(const float* __restrict__ pixels, const int* __restrict__ pack_idx,
                         const float* __restrict__ bank, const unsigned char* __restrict__ skip,
                         float* __restrict__ out, int n_img, int cap, int h, int w, int k,
                         int vec) {
  extern __shared__ __align__(16) float smem_sep[];
  const int r = (k - 1) / 2;
  const int off = sep_off(r);
  const int sh = kSepTile + k - 1;             // window rows (and row-sum rows)
  const int ld = sep_ld(k);
  // Taps buffer b at smem_sep + b * round4(k).
  float* win = smem_sep + 2 * round4(k);       // sh x ld
  float* mid = win + sh * ld;                  // sh x kSepTile
  const int tid = threadIdx.x;
  const int oy = (tid / (kSepTile / kColC)) * kColR;   // the thread's outputs in the tile
  const int ox = (tid % (kSepTile / kColC)) * kColC;
  const int x0 = blockIdx.x * kSepTile;
  const int y0 = blockIdx.y * kSepTile;
  const int64_t plane = static_cast<int64_t>(h) * w;
  auto stage = [&](int img, int b) {
    if (img < n_img && (skip == nullptr || skip[img] == 0)) {
      const int64_t src = source_slot(pack_idx, img, cap);
      stage_async(smem_sep + b * round4(k), win, bank, pixels + src * plane, src, h, w, k,
                  y0, x0, vec != 0, tid);
    }
    cp_async_commit();
  };
  int b = 0;
  stage(blockIdx.z, b);
  for (int img = blockIdx.z; img < n_img; img += gridDim.z, b ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // this image's copies, from every thread, have landed
    const float* taps = smem_sep + b * round4(k);
    float acc[kColR][kColC];
    if (skip != nullptr && skip[img] != 0) {   // block-uniform
#pragma unroll
      for (int i = 0; i < kColR; ++i)
#pragma unroll
        for (int c = 0; c < kColC; ++c) acc[i][c] = 0.0f;
      stage(img + gridDim.z, b ^ 1);          // the window is not read
    } else if (k == 1) {
#pragma unroll
      for (int i = 0; i < kColR; ++i)
#pragma unroll
        for (int c = 0; c < kColC; ++c) acc[i][c] = win[(oy + i) * ld + off + ox + c] * taps[0];
      __syncthreads();
      stage(img + gridDim.z, b ^ 1);
    } else {
      for (int item = tid; item < sh * (kSepTile / kRowC); item += kThreads) {
        const int yy = item / (kSepTile / kRowC);
        const int xx = (item % (kSepTile / kRowC)) * kRowC;
        float s[kRowC];
        row_sums(s, win + yy * ld + xx, taps, k, off);
        *reinterpret_cast<float4*>(mid + yy * kSepTile + xx) = make_float4(s[0], s[1], s[2], s[3]);
      }
      __syncthreads();  // the window is read: copy the next one
      stage(img + gridDim.z, b ^ 1);
      column_sums(acc, mid + oy * kSepTile + ox, taps, k);
    }
    // Taps buffer b is refilled two images on, after the next image's
    // first barrier: every thread has read it by then.
    store_block(out + img * plane, acc, y0 + oy, x0 + ox, h, w, vec != 0);
  }
}

cudaError_t launch_sep(const float* pixels, const int* pack_idx, const float* bank,
                       const unsigned char* skip, float* out, int n_img, int cap, int h, int w,
                       int k, int device, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * sep_smem_floats(k);
  cudaError_t err = cudaFuncSetAttribute(psf_match_sep_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // As many blocks as the card holds at once, each walking its images.
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, psf_match_sep_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int tiles = ((w + kSepTile - 1) / kSepTile) * ((h + kSepTile - 1) / kSepTile);
  const int z = std::max(1, std::min(std::min(n_img, 65535), per_sm * sms / tiles));
  // 16-byte rows: W a multiple of 4 and both base pointers on 16 bytes.
  const int vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(pixels) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((w + kSepTile - 1) / kSepTile, (h + kSepTile - 1) / kSepTile, z);
  psf_match_sep_kernel<<<grid, kThreads, smem, stream>>>(pixels, pack_idx, bank, skip, out,
                                                         n_img, cap, h, w, k, vec);
  return cudaGetLastError();
}

// ---- 2-D: register-blocked ----------------------------------------------

// A thread owns R rows x C columns of outputs (C a multiple of 4), on a
// 16 x 16 thread grid, so a tile of 16 R x 16 C outputs.  The entry point
// runs kernels kFixedKw taps wide on the fixed-width path, kFixedR x kFixedC,
// and every other width on the any-width path, kAnyR x kAnyC.
// SurveyConfig.psf_stamp_size's default (core/survey.py); a test holds them
// equal.
constexpr int kFixedKw = 13;
constexpr int kFixedR = 4;
constexpr int kFixedC = 8;
constexpr int kAnyR = 2;
constexpr int kAnyC = 8;
constexpr int k2dThreadsX = 16;
constexpr int k2dThreadsY = 16;
static_assert(k2dThreadsX * k2dThreadsY == kThreads, "stage_rows' warp count");

// Shared floats of psf_match_2d_kernel<R, C>: the taps in rows of
// round4(kw), the staged window in rows of round4(sw), and 4 floats of slack
// that the last window row's second 16-byte read may reach (never used in a
// sum).
template <int R, int C>
constexpr int smem_2d_floats(int kh, int kw) {
  return kh * round4(kw) + (R * k2dThreadsY + kh - 1) * round4(C * k2dThreadsX + kw - 1) + 4;
}

// rs[r][c] += the taps n0 .. n0 + 3 (those below kw) of kernel row wr - r,
// for each output row r that window row `wr` feeds, over the thread's C
// columns.  `xw` is the thread's first column in window row wr.  kAll: the
// window row feeds every one of the thread's rows (R - 1 <= wr <= kh - 1),
// so nothing is tested per row.
template <int R, int C, bool kAll, bool kTail>
__device__ __forceinline__ void taps_group(float (&rs)[R][C], const float* __restrict__ xw,
                                           const float* __restrict__ taps, int ktp, int wr,
                                           int kh, int n0, int kw) {
  float x[C + 4];
#pragma unroll
  for (int i = 0; i < C + 4; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(xw + n0 + i);
    x[i] = v.x, x[i + 1] = v.y, x[i + 2] = v.z, x[i + 3] = v.w;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int m = wr - r;
    if (!kAll && (m < 0 || m >= kh)) continue;
    const float4 tv = *reinterpret_cast<const float4*>(taps + m * ktp + n0);
    const float t[4] = {tv.x, tv.y, tv.z, tv.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (kTail && n0 + j >= kw) break;
#pragma unroll
      for (int c = 0; c < C; ++c) rs[r][c] = rs[r][c] + t[j] * x[c + j];
    }
  }
}

// One staged window row `wr`: each fed output row's sum over its kernel row
// (from 0, taps in ascending n), then added to that output.
template <int R, int C, bool kAll>
__device__ __forceinline__ void window_row(float (&acc)[R][C], const float* __restrict__ xw,
                                           const float* __restrict__ taps, int ktp, int wr,
                                           int kh, int kw) {
  float rs[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) rs[r][c] = 0.0f;
  const int full = kw & ~3;                    // taps in whole groups of 4
  for (int n0 = 0; n0 < full; n0 += 4)
    taps_group<R, C, kAll, false>(rs, xw, taps, ktp, wr, kh, n0, kw);
  if (full < kw) taps_group<R, C, kAll, true>(rs, xw, taps, ktp, wr, kh, full, kw);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int m = wr - r;
    if (!kAll && (m < 0 || m >= kh)) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = acc[r][c] + rs[r][c];
  }
}

// window_row for a compile-time kernel width KW: the thread's whole window
// row (C + KW - 1 pixels) and each fed kernel row's taps in registers, every
// loop unrolled.  The same sums in the same order.
template <int R, int C, int KW, bool kAll>
__device__ __forceinline__ void window_row_fixed(float (&acc)[R][C],
                                                 const float* __restrict__ xw,
                                                 const float* __restrict__ taps, int wr,
                                                 int kh) {
  constexpr int KTP = round4(KW);
  constexpr int NX = round4(C + KW - 1);
  float x[NX];
#pragma unroll
  for (int i = 0; i < NX; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(xw + i);
    x[i] = v.x, x[i + 1] = v.y, x[i + 2] = v.z, x[i + 3] = v.w;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int m = wr - r;
    if (!kAll && (m < 0 || m >= kh)) continue;
    float t[KTP];
#pragma unroll
    for (int i = 0; i < KTP; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(taps + m * KTP + i);
      t[i] = v.x, t[i + 1] = v.y, t[i + 2] = v.z, t[i + 3] = v.w;
    }
    float rs[C];
#pragma unroll
    for (int c = 0; c < C; ++c) rs[c] = 0.0f;
#pragma unroll
    for (int n = 0; n < KW; ++n)
#pragma unroll
      for (int c = 0; c < C; ++c) rs[c] = rs[c] + t[n] * x[c + n];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = acc[r][c] + rs[c];
  }
}

// KW > 0: built for kernels KW taps wide only (window_row_fixed); 0: any
// width (window_row, and Kw == 1 as one multiply).
template <int R, int C, int KW>
__global__ void __launch_bounds__(kThreads)
    psf_match_2d_kernel(const float* __restrict__ pixels, const int* __restrict__ pack_idx,
                        const float* __restrict__ bank, const unsigned char* __restrict__ skip,
                        float* __restrict__ out, int n_img, int cap, int h, int w, int kh,
                        int kw, int vec) {
  extern __shared__ __align__(16) float smem2d[];
  const int rh = (kh - 1) / 2;
  const int rw = (kw - 1) / 2;
  const int sh = R * k2dThreadsY + kh - 1;
  const int sw = C * k2dThreadsX + kw - 1;
  const int ktp = round4(kw);                  // tap row stride
  const int ld = round4(sw);                   // window row stride
  float* taps = smem2d;                        // kh x ktp
  float* win = taps + kh * ktp;                // sh x ld
  const int tid = threadIdx.y * k2dThreadsX + threadIdx.x;
  const int oy = threadIdx.y * R;              // the thread's block in the tile
  const int ox = threadIdx.x * C;
  const int x0 = blockIdx.x * C * k2dThreadsX;
  const int y0 = blockIdx.y * R * k2dThreadsY;
  const int64_t plane = static_cast<int64_t>(h) * w;
  for (int img = blockIdx.z; img < n_img; img += gridDim.z) {
    const int64_t src = source_slot(pack_idx, img, cap);
    float* dst = out + img * plane;
    const bool skipped = skip != nullptr && skip[img] != 0;   // block-uniform: zeros
    __syncthreads();  // the previous image's window is no longer read
    if (!skipped) {
      for (int i = tid; i < kh * ktp; i += kThreads) {
        const int m = i / ktp;
        const int n = i - m * ktp;
        taps[i] = n < kw ? __ldg(bank + src * kh * kw + m * kw + n) : 0.0f;
      }
      stage_rows(win, ld, pixels + src * plane, h, w, y0, rh, x0 - rw, sh, sw, vec != 0, tid);
    }
    __syncthreads();

    float acc[R][C];
    if (skipped) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] = 0.0f;
    } else if constexpr (KW > 0) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] = 0.0f;
      const float* xw = win + oy * ld + ox;
      for (int wr = 0; wr < R + kh - 1; ++wr, xw += ld) {
        if (wr >= R - 1 && wr < kh)
          window_row_fixed<R, C, KW, true>(acc, xw, taps, wr, kh);
        else
          window_row_fixed<R, C, KW, false>(acc, xw, taps, wr, kh);
      }
    } else if (kw == 1) {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] = win[(oy + r + rh) * ld + ox + c] * taps[0];
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] = 0.0f;
      // Window rows in ascending order: those feeding only some of the
      // thread's rows (the first R - 1 and the last), and between them
      // those feeding all.
      const float* xw = win + oy * ld + ox;
      for (int wr = 0; wr < R + kh - 1; ++wr, xw += ld) {
        if (wr >= R - 1 && wr < kh)
          window_row<R, C, true>(acc, xw, taps, ktp, wr, kh, kw);
        else
          window_row<R, C, false>(acc, xw, taps, ktp, wr, kh, kw);
      }
    }
    const int gx = x0 + ox;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int gy = y0 + oy + r;
      if (gy >= h || gx >= w) continue;
      float* o = dst + static_cast<int64_t>(gy) * w + gx;
      if (vec && gx + C <= w) {
#pragma unroll
        for (int c = 0; c < C; c += 4)
          *reinterpret_cast<float4*>(o + c) =
              make_float4(acc[r][c], acc[r][c + 1], acc[r][c + 2], acc[r][c + 3]);
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (gx + c < w) o[c] = acc[r][c];
      }
    }
  }
}

template <int R, int C, int KW>
cudaError_t launch_2d(const float* pixels, const int* pack_idx, const float* bank,
                      const unsigned char* skip, float* out, int n_img, int cap, int h, int w,
                      int kh, int kw, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_2d_floats<R, C>(kh, kw);
  cudaError_t err = cudaFuncSetAttribute(psf_match_2d_kernel<R, C, KW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // 16-byte rows: W a multiple of 4 and both base pointers on 16 bytes.
  const int vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(pixels) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int th = R * k2dThreadsY;
  const int tw = C * k2dThreadsX;
  const dim3 grid((w + tw - 1) / tw, (h + th - 1) / th, n_img < 65535 ? n_img : 65535);
  psf_match_2d_kernel<R, C, KW><<<grid, dim3(k2dThreadsX, k2dThreadsY), smem, stream>>>(
      pixels, pack_idx, bank, skip, out, n_img, cap, h, w, kh, kw, vec);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Each launches on `stream` (a
// cudaStream_t, e.g. torch.cuda.current_stream().cuda_stream) of `device`,
// does not synchronise, and returns the cudaError_t of the launch.  The
// wrapper (kernels/warp/ops.py) checks shapes and the tap limits; `out` is
// (G, cap, H, W) with G = n_img / cap, and `skip` a (G, cap) uint8 flag of
// images to write as zeros, or null to match every image.

extern "C" int psf_match_sep_f32(const float* pixels, const int* pack_idx, const float* bank,
                                 const unsigned char* skip, float* out, int n_img, int cap,
                                 int h, int w, int k, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_sep(pixels, pack_idx, bank, skip, out, n_img, cap, h, w, k,
                                     device, static_cast<cudaStream_t>(stream)));
}

extern "C" int psf_match_2d_f32(const float* pixels, const int* pack_idx, const float* bank,
                                const unsigned char* skip, float* out, int n_img, int cap, int h,
                                int w, int kh, int kw, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      kw == kFixedKw
          ? launch_2d<kFixedR, kFixedC, kFixedKw>(pixels, pack_idx, bank, skip, out, n_img, cap,
                                                  h, w, kh, kw, s)
          : launch_2d<kAnyR, kAnyC, 0>(pixels, pack_idx, bank, skip, out, n_img, cap, h, w, kh,
                                       kw, s));
}

// The any-width path for every width, 13 included: psf_match_2d_f32 without
// its fixed-width path, so that the two can be timed and checked on one bank.
extern "C" int psf_match_2d_any_f32(const float* pixels, const int* pack_idx, const float* bank,
                                    const unsigned char* skip, float* out, int n_img, int cap,
                                    int h, int w, int kh, int kw, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_2d<kAnyR, kAnyC, 0>(pixels, pack_idx, bank, skip, out, n_img,
                                                     cap, h, w, kh, kw,
                                                     static_cast<cudaStream_t>(stream)));
}

extern "C" const char* psf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
