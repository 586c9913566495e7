// Hopper (sm_90a) kernel of the brick mosaic: cached brick tiles added into
// one query canvas.
//
// Replaces the Pallas TPU kernel src/repro/kernels/warp/warp.py::mosaic_bricks
// (:700, _mosaic_kernel).  The TPU runs one grid step per brick, in order,
// with the whole (npix, npix) canvas resident in VMEM: zero it on the first
// step, then add each tile through a dynamic slice.  Hopper blocks run in
// parallel and in no order, so the order moves inside the block instead.
//
// What it computes, for any offsets: the plain version
// (repro_torch.core.reducer.mosaic_tiles), a zero canvas that accumulates
// canvas[r:r+bh, c:c+bw] += tile in brick order, each offset placed as the
// reference's dynamic_slice places it: a negative one counts once from the
// end (r + npix), then it is clamped to [0, npix - bh] x [0, npix - bw].
// Every canvas pixel is written exactly once by the thread that owns it, as
// a sum that starts at 0 and adds the pixel's covering tiles in brick
// order: the same float additions in the same order as the plain version,
// so the result is bitwise its, overlapping tiles included.  No atomics and
// no zeroing launch; uncovered pixels come out 0.  Element offsets are
// 64-bit.
//
// What bounds it on an H100: bytes.  Each tile and weight element is read
// once and each canvas pixel written once (2 * B * bh * bw + 2 * npix^2
// floats: 16.8 MB for 16 bricks of 256^2 into 1024^2, about 5 us at
// 3.35 TB/s); one add per element read.
//
// The design for that bound: a block of 256 threads owns a 64 x 64 canvas
// tile, and each thread 4 consecutive x pixels on 4 rows, 16 rows apart, so
// a warp reads and writes two 256-byte row segments at a time.  1024^2 is
// then 256 blocks, one wave on 132 SMs.  The block filters the covering
// bricks once for its whole tile (an ordered ballot compaction over chunks
// of 256 bricks into shared memory).  For a brick whose clamped column and
// width are multiples of 4 (the lattice: bricks at multiples of brick_npix)
// a thread's 4 pixels of a row are all inside the brick or all outside, and
// it loads them as one float4 from the tile and one from the weights: 8
// independent 16-byte loads in flight for a brick that covers its 4 rows.
// Any other brick takes the scalar path inside the same loop; the test is
// per brick, so it is uniform across the block.  Rows of the canvas are
// stored as float4 when npix is a multiple of 4.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// A tile's start along one axis: negative counts once from the end, then
// the tile is clamped onto the canvas.
__device__ __forceinline__ int place(int off, int npix, int max_start) {
  return min(max(off < 0 ? off + npix : off, 0), max_start);
}

constexpr int kVec = 4;                         // consecutive x pixels a thread owns
constexpr int kThreadsX = 16;                   // threads across a block tile
constexpr int kThreadsY = 16;                   // ... and down it
constexpr int kRows = 4;                        // rows a thread owns, kThreadsY apart
constexpr int kTileX = kThreadsX * kVec;        // 64 canvas pixels a block owns, along x
constexpr int kTileY = kThreadsY * kRows;       // ... and along y
constexpr int kThreads = kThreadsX * kThreadsY; // 256
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    mosaic_bricks_kernel(const float* __restrict__ tiles, const float* __restrict__ covs,
                         const int* __restrict__ offsets, float* __restrict__ coadd,
                         float* __restrict__ depth, int n_tiles, int bh, int bw, int npix,
                         bool vec_in, bool vec_out) {
  // The chunk's covering bricks, in brick order, with their clamped offsets.
  __shared__ int s_tile[kThreads];
  __shared__ int s_row[kThreads];
  __shared__ int s_col[kThreads];
  __shared__ int s_warp[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int x0 = blockIdx.x * kTileX;
  const int y0 = blockIdx.y * kTileY;
  const int x1 = min(x0 + kTileX, npix);   // exclusive
  const int y1 = min(y0 + kTileY, npix);
  const int x = x0 + (tid % kThreadsX) * kVec;   // the thread's first pixel
  const int y_first = y0 + tid / kThreadsX;      // its first row; then + kThreadsY
  const int max_r = npix - bh;
  const int max_c = npix - bw;
  const int64_t tile_elems = static_cast<int64_t>(bh) * bw;
  // The float4 path for a brick also needs its column a multiple of 4.
  const bool vec_bw = vec_in && bw % kVec == 0;

  float acc_c[kRows][kVec];
  float acc_d[kRows][kVec];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      acc_c[j][k] = 0.0f;
      acc_d[j][k] = 0.0f;
    }
  }

  for (int base = 0; base < n_tiles; base += kThreads) {
    // Filter: does brick b's clamped rectangle meet this block's tile?
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
    // Sum: this thread's pixels' covering tiles, in brick order.
    for (int i = 0; i < total; ++i) {
      const int br = s_row[i];
      const int bc = s_col[i];
      const int64_t tb = static_cast<int64_t>(s_tile[i]) * tile_elems;
      const int tx = x - bc;   // tile column of the thread's first pixel
      if (vec_bw && bc % kVec == 0) {
        // Aligned brick: the 4 pixels of a row are all inside or all out.
        if (tx < 0 || tx >= bw) continue;
        float4 tv[kRows];
        float4 cv[kRows];
        bool in[kRows];
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int ty = y_first + j * kThreadsY - br;
          in[j] = ty >= 0 && ty < bh;
          if (in[j]) {
            const int64_t e = tb + static_cast<int64_t>(ty) * bw + tx;
            tv[j] = __ldg(reinterpret_cast<const float4*>(tiles + e));
            cv[j] = __ldg(reinterpret_cast<const float4*>(covs + e));
          }
        }
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          if (!in[j]) continue;
          acc_c[j][0] = acc_c[j][0] + tv[j].x;
          acc_c[j][1] = acc_c[j][1] + tv[j].y;
          acc_c[j][2] = acc_c[j][2] + tv[j].z;
          acc_c[j][3] = acc_c[j][3] + tv[j].w;
          acc_d[j][0] = acc_d[j][0] + cv[j].x;
          acc_d[j][1] = acc_d[j][1] + cv[j].y;
          acc_d[j][2] = acc_d[j][2] + cv[j].z;
          acc_d[j][3] = acc_d[j][3] + cv[j].w;
        }
      } else {
        // Any other brick: pixel by pixel (a covered pixel lies on the
        // canvas, since the clamped brick does).
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const int ty = y_first + j * kThreadsY - br;
          if (ty < 0 || ty >= bh) continue;
          const int64_t row = tb + static_cast<int64_t>(ty) * bw;
#pragma unroll
          for (int k = 0; k < kVec; ++k) {
            if (tx + k < 0 || tx + k >= bw) continue;
            acc_c[j][k] = acc_c[j][k] + __ldg(tiles + row + tx + k);
            acc_d[j][k] = acc_d[j][k] + __ldg(covs + row + tx + k);
          }
        }
      }
    }
    __syncthreads();   // the next chunk overwrites the shared lists
  }

  // Each owned pixel written once: a float4 a row where the row is 4-aligned.
  const bool row_vec = vec_out && npix % kVec == 0 && x + kVec <= npix;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const int y = y_first + j * kThreadsY;
    if (y >= npix) continue;
    const int64_t o = static_cast<int64_t>(y) * npix + x;
    if (row_vec) {
      *reinterpret_cast<float4*>(coadd + o) =
          make_float4(acc_c[j][0], acc_c[j][1], acc_c[j][2], acc_c[j][3]);
      *reinterpret_cast<float4*>(depth + o) =
          make_float4(acc_d[j][0], acc_d[j][1], acc_d[j][2], acc_d[j][3]);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if (x + k < npix) {
          coadd[o + k] = acc_c[j][k];
          depth[o + k] = acc_d[j][k];
        }
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on `stream` (a
// cudaStream_t, e.g. torch.cuda.current_stream().cuda_stream) of `device`,
// does not synchronise, and returns the cudaError_t of the launch.  The
// wrapper (kernels/warp/ops.py::mosaic_bricks) checks shapes and that
// 1 <= bh, bw <= npix <= 65535 * 8; tiles and covs are (n_tiles, bh, bw),
// offsets (n_tiles, 2) int32 (row, col), coadd and depth (npix, npix).  The
// float4 paths are taken only where the pointers are 16-byte aligned.

extern "C" int mosaic_bricks_f32(const float* tiles, const float* covs, const int* offsets,
                                 float* coadd, float* depth, int n_tiles, int bh, int bw,
                                 int npix, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((npix + kTileX - 1) / kTileX, (npix + kTileY - 1) / kTileY);
  mosaic_bricks_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tiles, covs, offsets, coadd, depth, n_tiles, bh, bw, npix,
      aligned16(tiles) && aligned16(covs), aligned16(coadd) && aligned16(depth));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mosaic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
