// Hopper (sm_90a) kernel of the brick mosaic: cached brick tiles added into
// one query canvas.
//
// Replaces the Pallas TPU kernel src/repro/kernels/warp/warp.py::mosaic_bricks
// (:700, _mosaic_kernel).  The TPU runs one grid step per brick, in order,
// with the whole (npix, npix) canvas resident in VMEM: zero it on the first
// step, then add each tile through a dynamic slice.  Hopper blocks run in
// parallel and in no order, so the order moves inside the block instead:
// each block owns a 32 x 8 tile of canvas pixels and walks the bricks in
// brick order.  For each chunk of 256 bricks it first keeps, in order, the
// bricks whose clamped rectangle meets its pixels (one ballot per warp and
// a prefix over the eight warps, into shared memory); each thread then adds
// its pixel's covering tiles to a sum that starts at 0.  Every pixel is
// written exactly once, so there are no atomics and no separate zeroing
// launch, and uncovered pixels come out 0.
//
// What it computes, for any offsets: the plain version
// (repro_torch.core.reducer.mosaic_tiles), a zero canvas that accumulates
// canvas[r:r+bh, c:c+bw] += tile in brick order, each offset placed as the
// reference's dynamic_slice places it: a negative one counts once from the
// end (r + npix), then it is clamped to [0, npix - bh] x [0, npix - bw].  The sums
// are the same float additions in the same order, so the result is bitwise
// the plain version's, overlapping tiles included.  Element offsets are
// 64-bit.
//
// What bounds it on an H100: bytes.  Each tile and weight element is read
// once and each canvas pixel written once (2 * B * bh * bw + 2 * npix^2
// floats: 16.8 MB for 16 bricks of 256^2 into 1024^2, about 5 us at
// 3.35 TB/s); one add per element read.  At that size the launch dominates.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// A tile's start along one axis: negative counts once from the end, then
// the tile is clamped onto the canvas.
__device__ __forceinline__ int place(int off, int npix, int max_start) {
  return min(max(off < 0 ? off + npix : off, 0), max_start);
}

constexpr int kTileX = 32;   // canvas pixels a block owns, along x
constexpr int kTileY = 8;    // ... and along y
constexpr int kThreads = kTileX * kTileY;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    mosaic_bricks_kernel(const float* __restrict__ tiles, const float* __restrict__ covs,
                         const int* __restrict__ offsets, float* __restrict__ coadd,
                         float* __restrict__ depth, int n_tiles, int bh, int bw, int npix) {
  // The chunk's covering bricks, in brick order, with their clamped offsets.
  __shared__ int s_tile[kThreads];
  __shared__ int s_row[kThreads];
  __shared__ int s_col[kThreads];
  __shared__ int s_warp[kWarps];

  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int x0 = blockIdx.x * kTileX;
  const int y0 = blockIdx.y * kTileY;
  const int x1 = min(x0 + kTileX, npix);   // exclusive
  const int y1 = min(y0 + kTileY, npix);
  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  const bool on_canvas = x < npix && y < npix;
  const int max_r = npix - bh;
  const int max_c = npix - bw;
  const int64_t tile_elems = static_cast<int64_t>(bh) * bw;

  float acc_c = 0.0f;
  float acc_d = 0.0f;
  for (int base = 0; base < n_tiles; base += kThreads) {
    // Filter: does brick b's clamped rectangle meet this block's pixels?
    const int b = base + tid;
    int r = 0;
    int c = 0;
    bool hit = false;
    if (b < n_tiles) {
      r = place(offsets[2 * static_cast<int64_t>(b)], npix, max_r);
      c = place(offsets[2 * static_cast<int64_t>(b) + 1], npix, max_c);
      hit = r < y1 && r + bh > y0 && c < x1 && c + bw > x0;
    }
    // Order-preserving compaction: rank within the warp, then across warps.
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = 0;
    int total = 0;
    for (int v = 0; v < kWarps; ++v) {
      before += v < warp ? s_warp[v] : 0;
      total += s_warp[v];
    }
    if (hit) {
      const int slot = before + __popc(ballot & ((1u << lane) - 1u));
      s_tile[slot] = b;
      s_row[slot] = r;
      s_col[slot] = c;
    }
    __syncthreads();
    // Sum: this pixel's covering tiles, in brick order.
    if (on_canvas) {
      for (int i = 0; i < total; ++i) {
        const int ty = y - s_row[i];
        const int tx = x - s_col[i];
        if (ty >= 0 && ty < bh && tx >= 0 && tx < bw) {
          const int64_t e = static_cast<int64_t>(s_tile[i]) * tile_elems +
                            static_cast<int64_t>(ty) * bw + tx;
          acc_c = acc_c + __ldg(tiles + e);
          acc_d = acc_d + __ldg(covs + e);
        }
      }
    }
    __syncthreads();   // the next chunk overwrites the shared lists
  }
  if (on_canvas) {
    const int64_t o = static_cast<int64_t>(y) * npix + x;
    coadd[o] = acc_c;
    depth[o] = acc_d;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on `stream` (a
// cudaStream_t, e.g. torch.cuda.current_stream().cuda_stream) of `device`,
// does not synchronise, and returns the cudaError_t of the launch.  The
// wrapper (kernels/warp/ops.py::mosaic_bricks) checks shapes and that
// 1 <= bh, bw <= npix <= 65535 * 8; tiles and covs are (n_tiles, bh, bw),
// offsets (n_tiles, 2) int32 (row, col), coadd and depth (npix, npix).

extern "C" int mosaic_bricks_f32(const float* tiles, const float* covs, const int* offsets,
                                 float* coadd, float* depth, int n_tiles, int bh, int bw,
                                 int npix, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((npix + kTileX - 1) / kTileX, (npix + kTileY - 1) / kTileY);
  mosaic_bricks_kernel<<<grid, dim3(kTileX, kTileY), 0, static_cast<cudaStream_t>(stream)>>>(
      tiles, covs, offsets, coadd, depth, n_tiles, bh, bw, npix);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mosaic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
