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
// Both kernels stage an output tile plus its halo in shared memory, with
// source addresses clamped to the image edges (so an image narrower than the
// kernel clamps on both sides at once), and read the slot's taps into shared
// memory.  One block per (tile, image), 256 threads.  Flat offsets are
// 64-bit.
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
//
// What bounds them on an H100.  Each source pixel is read once and each
// matched pixel written once (8 bytes); a 13 x 13 kernel costs 338 fp32
// operations a pixel (a 15-tap separable one 60), against 67 TFLOP/s, so the
// 2-D kernel is bounded by operations and the separable one by bytes
// (3.35 TB/s).  Since no product may fuse with its sum, a tap is an FMUL and
// an FADD: the 2-D kernel cannot beat twice its operation bound.
//
// psf_match_sep_kernel: a 32 x 32 tile, four outputs a thread; each tap is
// a shared-memory load, a multiply and an add issued on their own.
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
// Window rows that feed all R output rows run without a test per row.  Each
// output still adds its kernel rows in ascending m, each row summed over
// ascending n from 0, so blocking reorders work across outputs and never
// within one: the result is bitwise that of the plain version.  The window
// is staged in 16-byte loads aligned in the image (clamped element by
// element at the edges, or throughout when W is not a multiple of 4), rows
// of taps padded to a multiple of 4 with zeros that are never read into a
// sum.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 32;          // output tile edge
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;

// The slot an image of the scratch comes from: pack pack_idx[g], slot s.
__device__ __forceinline__ int64_t source_slot(const int* __restrict__ pack_idx, int img,
                                               int cap) {
  return static_cast<int64_t>(pack_idx[img / cap]) * cap + img % cap;
}

// Stage the (tile + halo) window of one image, clamped to its edges.
__device__ __forceinline__ void stage(float* __restrict__ dst, const float* __restrict__ im,
                                      int h, int w, int y0, int x0, int rh, int rw, int sh,
                                      int sw, int tid) {
  for (int i = tid; i < sh * sw; i += kThreads) {
    const int yy = i / sw;
    const int xx = i - yy * sw;
    const int gy = min(max(y0 + yy - rh, 0), h - 1);
    const int gx = min(max(x0 + xx - rw, 0), w - 1);
    dst[i] = __ldg(im + static_cast<int64_t>(gy) * w + gx);
  }
}

__global__ void __launch_bounds__(kThreads)
    psf_match_sep_kernel(const float* __restrict__ pixels, const int* __restrict__ pack_idx,
                         const float* __restrict__ bank, float* __restrict__ out, int n_img,
                         int cap, int h, int w, int k) {
  extern __shared__ float smem[];
  const int r = (k - 1) / 2;
  const int sw = kTile + 2 * r;    // staged window, square
  float* taps = smem;              // k
  float* win = taps + k;           // sw * sw source pixels
  float* mid = win + sw * sw;      // sw rows x kTile: the row pass
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  const int64_t plane = static_cast<int64_t>(h) * w;
  for (int img = blockIdx.z; img < n_img; img += gridDim.z) {
    const int64_t src = source_slot(pack_idx, img, cap);
    float* dst = out + img * plane;
    __syncthreads();  // the previous image's window is no longer read
    for (int i = tid; i < k; i += kThreads) taps[i] = __ldg(bank + src * k + i);
    stage(win, pixels + src * plane, h, w, y0, x0, r, r, sw, sw, tid);
    __syncthreads();
    if (k == 1) {
      for (int i = tid; i < kTile * kTile; i += kThreads) {
        const int yy = i / kTile, xx = i - (i / kTile) * kTile;
        if (y0 + yy < h && x0 + xx < w)
          dst[static_cast<int64_t>(y0 + yy) * w + x0 + xx] = win[yy * sw + xx] * taps[0];
      }
      continue;
    }
    for (int i = tid; i < sw * kTile; i += kThreads) {  // rows along W
      const int yy = i / kTile, xx = i - (i / kTile) * kTile;
      const float* row = win + yy * sw + xx;
      float acc = 0.0f;
      for (int m = 0; m < k; ++m) acc = acc + taps[m] * row[m];
      mid[i] = acc;
    }
    __syncthreads();
    for (int i = tid; i < kTile * kTile; i += kThreads) {  // columns along H
      const int yy = i / kTile, xx = i - (i / kTile) * kTile;
      if (y0 + yy >= h || x0 + xx >= w) continue;
      const float* col = mid + yy * kTile + xx;
      float acc = 0.0f;
      for (int m = 0; m < k; ++m) acc = acc + taps[m] * col[m * kTile];
      dst[static_cast<int64_t>(y0 + yy) * w + x0 + xx] = acc;
    }
  }
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

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Shared floats of psf_match_2d_kernel<R, C>: the taps in rows of
// round4(kw), the staged window in rows of round4(sw), and 4 floats of slack
// that the last window row's second 16-byte read may reach (never used in a
// sum).
template <int R, int C>
constexpr int smem_2d_floats(int kh, int kw) {
  return kh * round4(kw) + (R * k2dThreadsY + kh - 1) * round4(C * k2dThreadsX + kw - 1) + 4;
}

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
  for (int yy = tid >> 5; yy < sh; yy += k2dThreadsX * k2dThreadsY / 32) {
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
__global__ void __launch_bounds__(k2dThreadsX * k2dThreadsY)
    psf_match_2d_kernel(const float* __restrict__ pixels, const int* __restrict__ pack_idx,
                        const float* __restrict__ bank, float* __restrict__ out, int n_img,
                        int cap, int h, int w, int kh, int kw, int vec) {
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
    __syncthreads();  // the previous image's window is no longer read
    for (int i = tid; i < kh * ktp; i += k2dThreadsX * k2dThreadsY) {
      const int m = i / ktp;
      const int n = i - m * ktp;
      taps[i] = n < kw ? __ldg(bank + src * kh * kw + m * kw + n) : 0.0f;
    }
    stage_rows(win, ld, pixels + src * plane, h, w, y0, rh, x0 - rw, sh, sw, vec != 0, tid);
    __syncthreads();

    float acc[R][C];
    if constexpr (KW > 0) {
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
cudaError_t launch_2d(const float* pixels, const int* pack_idx, const float* bank, float* out,
                      int n_img, int cap, int h, int w, int kh, int kw, cudaStream_t stream) {
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
      pixels, pack_idx, bank, out, n_img, cap, h, w, kh, kw, vec);
  return cudaGetLastError();
}

dim3 tile_grid(int h, int w, int n_img) {
  return dim3((w + kTile - 1) / kTile, (h + kTile - 1) / kTile,
              n_img < 65535 ? n_img : 65535);
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Each launches on `stream` (a
// cudaStream_t, e.g. torch.cuda.current_stream().cuda_stream) of `device`,
// does not synchronise, and returns the cudaError_t of the launch.  The
// wrapper (kernels/warp/ops.py) checks shapes and the tap limits; `out` is
// (G, cap, H, W) with G = n_img / cap.

extern "C" int psf_match_sep_f32(const float* pixels, const int* pack_idx, const float* bank,
                                 float* out, int n_img, int cap, int h, int w, int k,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sw = kTile + (k - 1);
  const size_t smem = sizeof(float) * (static_cast<size_t>(k) + sw * sw + sw * kTile);
  psf_match_sep_kernel<<<tile_grid(h, w, n_img), dim3(kThreadsX, kThreadsY), smem,
                         static_cast<cudaStream_t>(stream)>>>(pixels, pack_idx, bank, out,
                                                              n_img, cap, h, w, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int psf_match_2d_f32(const float* pixels, const int* pack_idx, const float* bank,
                                float* out, int n_img, int cap, int h, int w, int kh, int kw,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      kw == kFixedKw
          ? launch_2d<kFixedR, kFixedC, kFixedKw>(pixels, pack_idx, bank, out, n_img, cap, h, w,
                                                  kh, kw, s)
          : launch_2d<kAnyR, kAnyC, 0>(pixels, pack_idx, bank, out, n_img, cap, h, w, kh, kw,
                                       s));
}

// The any-width path for every width, 13 included: psf_match_2d_f32 without
// its fixed-width path, so that the two can be timed and checked on one bank.
extern "C" int psf_match_2d_any_f32(const float* pixels, const int* pack_idx, const float* bank,
                                    float* out, int n_img, int cap, int h, int w, int kh, int kw,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_2d<kAnyR, kAnyC, 0>(pixels, pack_idx, bank, out, n_img, cap, h,
                                                     w, kh, kw, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* psf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
