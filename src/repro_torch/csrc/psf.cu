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
// Both kernels stage a 32 x 32 output tile plus its halo in shared memory,
// with source addresses clamped to the image edges (so an image narrower
// than the kernel clamps on both sides at once), and read the slot's taps
// into shared memory.  One block per (tile, image); 256 threads, four
// outputs each.  Flat offsets are 64-bit.
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
// (3.35 TB/s).  Each tap here is a shared-memory load, a multiply and an add
// issued on their own; tensor cores (the 2-D correlation as Kh small
// matrix products) and TMA staging are later work.

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

__global__ void __launch_bounds__(kThreads)
    psf_match_2d_kernel(const float* __restrict__ pixels, const int* __restrict__ pack_idx,
                        const float* __restrict__ bank, float* __restrict__ out, int n_img,
                        int cap, int h, int w, int kh, int kw) {
  extern __shared__ float smem[];
  const int rh = (kh - 1) / 2;
  const int rw = (kw - 1) / 2;
  const int sh = kTile + 2 * rh;
  const int sw = kTile + 2 * rw;
  const int nt = kh * kw;
  float* taps = smem;              // kh * kw
  float* win = taps + nt;          // sh * sw source pixels
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  const int64_t plane = static_cast<int64_t>(h) * w;
  for (int img = blockIdx.z; img < n_img; img += gridDim.z) {
    const int64_t src = source_slot(pack_idx, img, cap);
    float* dst = out + img * plane;
    __syncthreads();
    for (int i = tid; i < nt; i += kThreads) taps[i] = __ldg(bank + src * nt + i);
    stage(win, pixels + src * plane, h, w, y0, x0, rh, rw, sh, sw, tid);
    __syncthreads();
    const int xx = threadIdx.x;
    if (x0 + xx >= w) continue;
    for (int yy = threadIdx.y; yy < kTile; yy += kThreadsY) {
      if (y0 + yy >= h) break;
      float acc;
      if (kw == 1) {
        acc = win[(yy + rh) * sw + xx] * taps[0];
      } else {
        acc = 0.0f;
        for (int m = 0; m < kh; ++m) {
          const float* row = win + (yy + m) * sw + xx;
          const float* t = taps + m * kw;
          float rs = 0.0f;
          for (int n = 0; n < kw; ++n) rs = rs + t[n] * row[n];
          acc = acc + rs;
        }
      }
      dst[static_cast<int64_t>(y0 + yy) * w + x0 + xx] = acc;
    }
  }
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
  const size_t sh = kTile + (kh - 1);
  const size_t sw = kTile + (kw - 1);
  const size_t smem = sizeof(float) * (static_cast<size_t>(kh) * kw + sh * sw);
  psf_match_2d_kernel<<<tile_grid(h, w, n_img), dim3(kThreadsX, kThreadsY), smem,
                        static_cast<cudaStream_t>(stream)>>>(pixels, pack_idx, bank, out,
                                                             n_img, cap, h, w, kh, kw);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* psf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
