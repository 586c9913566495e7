// Hopper (sm_90a) kernels of the warp stage.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/warp/warp.py:
//   warp_project  (_warp_kernel)           -> warp_project_kernel
//   coadd_fused   (_coadd_fused_kernel)    -> pack_scan_kernel<SumAcc>
//   coadd_moments (_coadd_moments_kernel)  -> pack_scan_kernel<MomentsAcc>
//   coadd_clip    (_coadd_clip_kernel)     -> pack_scan_kernel<ClipAcc>
//   coadd_hist    (_coadd_hist_kernel)     -> pack_scan_kernel<HistAcc<nbins>>
// All are built on one __device__ routine, warp_sample, which is what
// _sky_to_pixel + _bilinear_via_matmul compute: gnomonic sky->pixel per
// output pixel, an edge-clamped bilinear sample, and the inside mask over
// [0, W-1] x [0, H-1].  The TPU kernel gathers rows with one-hot matmuls and
// selects columns with a masked reduction because the TPU has no gather
// unit; here each thread loads its four neighbours directly through the
// read-only data path.
//
// What bounds them on an H100.  One sample (output pixel x image) is about
// 50 fp32 operations counted as the formula reads (two accurate trig calls
// on the RA offset, three divisions, the bilinear blend), against 67 TFLOP/s
// of fp32 outside the tensor cores; each is one instruction sequence of its
// own here (sinf alone is tens of instructions), so the kernels sit well
// above that bound.  warp_project writes 8 bytes per sample (tile and
// coverage) against ~49 operations, under the card's ~20 operations per
// byte of 3.35 TB/s, so it is bounded by bytes.  The four neighbour loads
// mostly hit L1/L2: neighbouring output pixels read neighbouring source
// pixels, and a sample off the image clamps to its edge, one address for a
// whole warp.  Sin/cos of the output pixel's declination are taken once per
// thread, and the per-image terms (sin/cos of the WCS reference
// declination, the CD determinant) once per image per block, staged in
// shared memory.
//
// A pack scan is one whole pass of a query in ONE launch: one thread owns
// one output pixel of a 32 x 8 block tile, the block walks the G gated
// packs x cap slots inside the kernel, and each thread keeps its sums in
// registers: no atomics, a fixed order, and no (N, Q, Q) stack ever
// written.  As in the reference scan, each pack's partial sums are added to
// the carry after the pack.  The four passes differ only in the per-sample
// accumulator, a template parameter; the robust ones read their fixed
// (Q, Q) operands (clip centre and radius, histogram bounds) once per
// thread into registers.
//
// Culling (pack_scan_kernel, the form every wrapper launches).  A query's
// frames are few and small beside the grid: on the survey's main path 164
// of 512 (or 2880) scanned slots are accepted, and each covers about 5 % of
// the grid, so a 32 x 8 tile is reached by about 9.5 of them.  A slot adds
// nothing to a block's tile when
//   (a) it is rejected (accept == 0) and its flag in `finite` is set: every
//       pixel finite with |p| <= 2^62 (PackedDataset.to_device; ops.py
//       derives the PSF scratch's flag).  A rejected sample then adds
//       (finite vm) * 0 = +-0, and vm*vm stays finite, so MomentsAcc's
//       vm*vm/m * 0 is +-0 too.  Without the flag it may add NaN: kept.
//   (b) its accept is finite and its footprint misses the tile.  A sample
//       outside the frame is the select's exact 0 with coverage 0, so it
//       adds 0 * a = +-0 to every sum (HistAcc adds weight 0 to some bin,
//       or returns on NaN).
// A block culls the whole scan at once, not pack by pack:
//   1. Candidates: the scan's G * cap slots in rounds of 256, one slot a
//      thread, with no trig: load the accept and the flag, apply (a), and
//      compact the candidates in scan order (warp ballot and prefix) into a
//      shared buffer of (scan position g, slot, accept).  A round may hold
//      slots of several packs, and a pack may span rounds (cap > 256).
//   2. Footprint: whenever 256 candidates wait, or the scan has ended, each
//      thread takes one, builds its SlotConst (two trig calls) and applies
//      (b); the kept slots are compacted in order into the kept list.
//   3. Sampling: each thread walks the kept list in order.  A kept slot of
//      another pack than the last one closes that pack's partial
//      (end_pack) and opens its own (begin_pack); the scan's end closes
//      the last.  A pack whose kept slots fall into two footprint rounds
//      keeps its partial open across them.
// So the main path's sparse pass stages 2 cheap rounds and 1 footprint
// round of 164 candidates a block, not 8 packs of 64 staging threads with
// three barriers each, and a dense one 12 cheap rounds, not 45 packs.
// Why the result is bitwise the unculled scan's: adding +-0 leaves every
// partial unchanged, since a sum that starts at +0 is never -0 under
// round-to-nearest and x + (+-0) == x for any other x (a NaN stays the
// card's one NaN).  A pack with no kept slot goes unframed: its partial in
// the unculled scan is +0 (a sum of +-0 that starts at +0), and the carry,
// which also starts at +0, is never -0, so carry + (+0) is the carry.
// Every other pack is framed where the unculled scan frames it, after its
// last slot and before the next pack's first, and its kept slots are added
// in scan order.  So every sum that is not skipped is added in the
// unculled kernel's order, and the result is the same bits.  The footprint
// test of (b), `misses_tile`, is exact
// for any grid: the block's tile is split into four 8 x 8 sub-tiles, each
// with a centre pixel c and the largest chord r from c to its pixels
// (computed once per block); every pixel of the sub-tile lies within the
// spherical cap (c, r).  The gnomonic projection stretches arc length by
// at most 1/cos^2(theta) at angle theta from the frame's tangent point, so
// every pixel's (sx, sy) lies within (r + e) / cos^2(theta_c + r) times
// the CD inverse's row sums of c's own (sx, sy), where e = 4e-6 rad covers
// the float32 rounding of a sample's sky->pixel map (under 1e-6 rad), plus
// 1 px and 2e-5 of |sx| + |sy| for the CD products and the reference-pixel
// addition.  The slot is culled only if that box misses [0, W-1] x
// [0, H-1] for every live sub-tile, and only when c maps to finite (sx, sy)
// with cos(theta_c + r) > 0.05; anything else keeps the slot.  So what
// bounds a culled scan is the samples that contribute (about the query's
// depth sum), the footprint tests (one a candidate and block) and the
// block-uniform branches.  Each accumulator sets the kernel's minimum
// resident blocks (kMinBlocks, __launch_bounds__): the register cap that
// builds it without spills.  Its shared memory, 20.2 KB a block, allows
// the SM's eight blocks of 256 threads.  pack_scan_unculled_kernel is the
// unculled scan, pack by pack in chunks of 256 slots, every slot sampled:
// one extra C entry point (pack_scan_unculled_f32) for chip_smoke.py to
// hold the culled form against bitwise; no wrapper launches it.
//
// Batches (paper Fig. 5).  A pack scan carries a query axis: blockIdx.z is
// the query k of K, and each block reads that query's accept (K, G, cap),
// grids (K, Q, Q) and fixed operands (K, Q, Q), and writes its own output
// planes; pixels, WCS, the pack index and the finite flag are shared by
// every query.  The candidates and the footprint caps come from that
// query's accept and grid, so culling is per query, and the slot order is
// the one-query kernel's: each query of a batch is bitwise its own
// one-query launch on the same pack index, which is pack_scan_f32 with
// n_queries = 1.
//
// warp_project_kernel is culled by (b) alone: it writes every image's tile,
// so a culled (tile, image) pair writes 0 * a to tile and coverage without
// sampling, which is what the select gives there.  Its bytes bound it (8 per
// output pixel and image): a block walks a chunk of images over its 32 x 8
// tile, so the pixel trig and the tile's caps are taken once a chunk and the
// slots' constants staged by one thread each, and it writes with streaming
// stores.  The unculled kernel (one image a block, every sample computed) is
// the check form, warp_project_unculled_f32, held bitwise by chip_smoke.py.
//
// Numerics: built WITHOUT --use_fast_math and with -fmad=false, so every
// product and sum rounds on its own, as in the plain torch version (one
// elementwise op per torch kernel), and sinf/cosf are the accurate library
// routines torch.sin/torch.cos also use.  Coordinates are clamped into
// [-1, W] x [-1, H] (a NaN to -1, by fmaxf) before the float->int conversion
// (undefined for huge |sx|); the inside test uses the unclamped values.  Flat offsets are 64-bit:
// P*cap*H*W exceeds 2^31 at survey scale.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kDeg2Rad = static_cast<float>(3.14159265358979323846 / 180.0);
constexpr float kRad2Deg = static_cast<float>(180.0 / 3.14159265358979323846);
constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kThreads = kTileX * kTileY;

// Per-image terms of the sky->pixel map, shared by every output pixel.
struct SlotConst {
  float ra0_r, sin_dec0, cos_dec0, x0, y0, cd11, cd12, cd21, cd22, det, a;
};

__device__ __forceinline__ SlotConst make_slot(const float* __restrict__ w, float a) {
  SlotConst c;
  c.ra0_r = w[0] * kDeg2Rad;
  const float dec0_r = w[1] * kDeg2Rad;
  c.sin_dec0 = sinf(dec0_r);
  c.cos_dec0 = cosf(dec0_r);
  c.x0 = w[2];
  c.y0 = w[3];
  c.cd11 = w[4];
  c.cd12 = w[5];
  c.cd21 = w[6];
  c.cd22 = w[7];
  c.det = c.cd11 * c.cd22 - c.cd12 * c.cd21;
  c.a = a;
  return c;
}

// Gnomonic sky -> source pixel of slot c at a sky point given as (ra_r,
// sin_dec, cos_dec); cosc is the cosine of its angle from c's tangent
// point.  Operation order is the reference's (_sky_to_pixel).
__device__ __forceinline__ void sky_to_src(const SlotConst& c, float ra_r, float sin_dec,
                                           float cos_dec, float& sx, float& sy, float& cosc) {
  const float dra = ra_r - c.ra0_r;
  const float cos_dra = cosf(dra);
  const float sin_dra = sinf(dra);
  cosc = c.sin_dec0 * sin_dec + c.cos_dec0 * cos_dec * cos_dra;
  const float xi = cos_dec * sin_dra / cosc * kRad2Deg;
  const float eta = (c.cos_dec0 * sin_dec - c.sin_dec0 * cos_dec * cos_dra) / cosc * kRad2Deg;
  sx = (c.cd22 * xi - c.cd12 * eta) / c.det + c.x0;
  sy = (-c.cd21 * xi + c.cd11 * eta) / c.det + c.y0;
}

// One sample: returns val * m and m for the image `img` (H, W) at the output
// pixel whose sky position gives (ra_r, sin_dec, cos_dec).  Operation order
// is the reference's (_sky_to_pixel, _bilinear_via_matmul).
__device__ __forceinline__ void warp_sample(const float* __restrict__ img, int h, int w,
                                            const SlotConst& c, float ra_r, float sin_dec,
                                            float cos_dec, float& vm, float& m) {
  float sx, sy, cosc;
  sky_to_src(c, ra_r, sin_dec, cos_dec, sx, sy, cosc);

  const float sxc = fminf(fmaxf(sx, -1.0f), static_cast<float>(w));
  const float syc = fminf(fmaxf(sy, -1.0f), static_cast<float>(h));
  const float x0f = floorf(sxc);
  const float y0f = floorf(syc);
  const float dx = sxc - x0f;
  const float dy = syc - y0f;
  const int x0i = static_cast<int>(x0f);
  const int y0i = static_cast<int>(y0f);
  const int xa = min(max(x0i, 0), w - 1);
  const int xb = min(max(x0i + 1, 0), w - 1);
  const int ya = min(max(y0i, 0), h - 1);
  const int yb = min(max(y0i + 1, 0), h - 1);
  const float* r0 = img + static_cast<int64_t>(ya) * w;
  const float* r1 = img + static_cast<int64_t>(yb) * w;
  const float v00 = __ldg(r0 + xa);
  const float v01 = __ldg(r0 + xb);
  const float v10 = __ldg(r1 + xa);
  const float v11 = __ldg(r1 + xb);
  const float val = v00 * (1.0f - dx) * (1.0f - dy) + v01 * dx * (1.0f - dy) +
                    v10 * (1.0f - dx) * dy + v11 * dx * dy;
  const bool inside = (sx >= 0.0f) && (sx <= static_cast<float>(w - 1)) && (sy >= 0.0f) &&
                      (sy <= static_cast<float>(h - 1));
  // A select, not val * m: the reference's compiled program turns the
  // product with its converted mask into one, so an uncovered sample is
  // exactly 0 even where sx is NaN (an empty slot's all-zero WCS).
  vm = inside ? val : 0.0f;
  m = inside ? 1.0f : 0.0f;
}

// Output-pixel coordinates of this thread and the per-pixel trig.
struct PixelSky {
  int64_t o;
  bool live;
  float ra_r, sin_dec, cos_dec;
};

__device__ __forceinline__ PixelSky pixel_sky(const float* __restrict__ gra,
                                              const float* __restrict__ gdec, int q) {
  PixelSky s;
  const int col = blockIdx.x * kTileX + threadIdx.x;
  const int row = blockIdx.y * kTileY + threadIdx.y;
  s.live = col < q && row < q;
  s.o = static_cast<int64_t>(row) * q + col;
  s.ra_r = 0.0f;
  s.sin_dec = 0.0f;
  s.cos_dec = 1.0f;
  if (s.live) {
    s.ra_r = gra[s.o] * kDeg2Rad;
    const float dec_r = gdec[s.o] * kDeg2Rad;
    s.sin_dec = sinf(dec_r);
    s.cos_dec = cosf(dec_r);
  }
  return s;
}

// The unculled warp_project (the check form): one image a block, every
// sample computed.
__global__ void __launch_bounds__(kThreads)
    warp_project_unculled_kernel(const float* __restrict__ pixels,
                                 const float* __restrict__ wcs,
                                 const float* __restrict__ accept,
                                 const float* __restrict__ gra, const float* __restrict__ gdec,
                                 float* __restrict__ tile, float* __restrict__ cov, int n_img,
                                 int h, int w, int q) {
  __shared__ SlotConst slot;
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const PixelSky px = pixel_sky(gra, gdec, q);
  const int64_t plane = static_cast<int64_t>(h) * w;
  const int64_t qq = static_cast<int64_t>(q) * q;
  for (int n = blockIdx.z; n < n_img; n += gridDim.z) {
    __syncthreads();  // the previous image's slot is no longer read
    if (tid == 0) slot = make_slot(wcs + static_cast<int64_t>(n) * 8, accept[n]);
    __syncthreads();
    if (px.live) {
      float vm, m;
      warp_sample(pixels + n * plane, h, w, slot, px.ra_r, px.sin_dec, px.cos_dec, vm, m);
      tile[n * qq + px.o] = vm * slot.a;
      cov[n * qq + px.o] = m * slot.a;
    }
  }
}

// ----- per-sample accumulators of the pack scan ---------------------------
//
// Each keeps a per-pack partial and the carry in registers.  load() reads
// the thread's fixed operands (live threads only), add() takes one sample
// (vm, m) of a slot with accept weight a, end_pack() adds the partial to
// the carry, store() writes the outputs.  Each add() repeats its Pallas
// body's arithmetic in the same order.  query(args, k, qq) moves every
// pointer to query k's planes of a batch.  kMinBlocks is the culled
// kernel's minimum resident blocks an SM, so its register cap is 65536 /
// (256 kMinBlocks) a thread, chosen where ptxas (CUDA 12.9) builds it
// without spills: Sum, Moments, Clip and Hist<8> take 62-64 registers at
// 4 (Moments and Clip spill at 5); Hist<16> 80 at 3; Hist<32> spills at 2
// (128), so it keeps one block an SM and 147 registers.

struct SumAcc {  // coadd_fused: sum a*vm, sum a*m
  struct Args {
    float* coadd;
    float* depth;
  };
  static constexpr int kMinBlocks = 4;
  float c = 0.0f, d = 0.0f, pc = 0.0f, pd = 0.0f;
  static __device__ Args query(const Args& p, int64_t k, int64_t qq) {
    return {p.coadd + k * qq, p.depth + k * qq};
  }
  __device__ void load(const Args&, int64_t) {}
  __device__ void begin_pack() { pc = pd = 0.0f; }
  __device__ void add(float vm, float m, float a) {
    pc += vm * a;
    pd += m * a;
  }
  __device__ void end_pack() {
    c += pc;
    d += pd;
  }
  __device__ void store(const Args& p, int64_t o) const {
    p.coadd[o] = c;
    p.depth[o] = d;
  }
};

struct MomentsAcc {  // robust pass 1: S0 = sum a*m, S1 = sum a*vm, S2 = sum a*vm^2/m
  struct Args {
    float* s0;
    float* s1;
    float* s2;
  };
  static constexpr int kMinBlocks = 4;
  float s[3] = {0.0f, 0.0f, 0.0f}, p[3] = {0.0f, 0.0f, 0.0f};
  static __device__ Args query(const Args& a, int64_t k, int64_t qq) {
    return {a.s0 + k * qq, a.s1 + k * qq, a.s2 + k * qq};
  }
  __device__ void load(const Args&, int64_t) {}
  __device__ void begin_pack() { p[0] = p[1] = p[2] = 0.0f; }
  __device__ void add(float vm, float m, float a) {
    // vm is already mask-scaled, so t^2/c with 0/1 coverage is vm*vm/m.
    const float s2c = m > 0.0f ? vm * vm / m : 0.0f;
    p[0] += m * a;
    p[1] += vm * a;
    p[2] += s2c * a;
  }
  __device__ void end_pack() {
#pragma unroll
    for (int k = 0; k < 3; ++k) s[k] += p[k];
  }
  __device__ void store(const Args& q, int64_t o) const {
    q.s0[o] = s[0];
    q.s1[o] = s[1];
    q.s2[o] = s[2];
  }
};

struct ClipAcc {  // final pass: sums of the samples inside the clip window
  struct Args {
    const float* center;
    const float* thresh;
    float* coadd;
    float* depth;
  };
  static constexpr int kMinBlocks = 4;
  float center = 0.0f, thresh = 0.0f;
  float c = 0.0f, d = 0.0f, pc = 0.0f, pd = 0.0f;
  static __device__ Args query(const Args& p, int64_t k, int64_t qq) {
    return {p.center + k * qq, p.thresh + k * qq, p.coadd + k * qq, p.depth + k * qq};
  }
  __device__ void load(const Args& p, int64_t o) {
    center = p.center[o];
    thresh = p.thresh[o];
  }
  __device__ void begin_pack() { pc = pd = 0.0f; }
  __device__ void add(float vm, float m, float a) {
    // Division-free: |vm - m*center| <= m*thresh == |vm/m - center| <= thresh
    // for m > 0, the form every path of the reference tests.
    const float keep =
        (m > 0.0f && fabsf(vm - m * center) <= m * thresh) ? 1.0f : 0.0f;
    pc += vm * keep * a;
    pd += m * keep * a;
  }
  __device__ void end_pack() {
    c += pc;
    d += pd;
  }
  __device__ void store(const Args& p, int64_t o) const {
    p.coadd[o] = c;
    p.depth[o] = d;
  }
};

template <int NB>
struct HistAcc {  // median round 1: hist[b] += a*m at b = clip(floor((x-lo)*inv_w))
  struct Args {
    const float* lo;
    const float* inv_w;
    float* hist;  // (NB, Q, Q)
    int64_t qq;
  };
  static constexpr int kMinBlocks = NB <= 8 ? 4 : NB <= 16 ? 3 : 1;
  float lo = 0.0f, inv_w = 0.0f;
  float h[NB] = {}, ph[NB] = {};
  static __device__ Args query(const Args& p, int64_t k, int64_t qq) {
    return {p.lo + k * qq, p.inv_w + k * qq, p.hist + k * NB * qq, p.qq};
  }
  __device__ void load(const Args& p, int64_t o) {
    lo = p.lo[o];
    inv_w = p.inv_w[o];
  }
  __device__ void begin_pack() {
#pragma unroll
    for (int j = 0; j < NB; ++j) ph[j] = 0.0f;
  }
  __device__ void add(float vm, float m, float a) {
    const float x = m > 0.0f ? vm / m : 0.0f;
    const float t = floorf((x - lo) * inv_w);
    const float wgt = m * a;
    // Clamp in float, as jnp.clip does, then convert: converting an inf is
    // undefined.  A NaN lands in no bin (b == j is false for every j in the
    // reference), and fminf/fmaxf would map it to a bin, so it is skipped.
    if (t != t) return;
    const int b = static_cast<int>(fminf(fmaxf(t, 0.0f), static_cast<float>(NB - 1)));
    // Unrolled compare-and-select over the bins, the reference's static bin
    // loop: h[] stays in registers (a runtime index would put it in local
    // memory).  wgt * (b == j) adds +0 to every other bin, a no-op.
#pragma unroll
    for (int j = 0; j < NB; ++j) ph[j] += (b == j) ? wgt : 0.0f;
  }
  __device__ void end_pack() {
#pragma unroll
    for (int j = 0; j < NB; ++j) h[j] += ph[j];
  }
  __device__ void store(const Args& p, int64_t o) const {
#pragma unroll
    for (int j = 0; j < NB; ++j) p.hist[j * p.qq + o] = h[j];
  }
};

// ----- footprint culling (see the header) --------------------------------

constexpr int kWarps = kThreads / 32;
constexpr int kSub = 4;                  // 8 x 8 sub-tiles of a 32 x 8 block tile
constexpr int kSubW = kTileX / kSub;
constexpr float kMaxChord = 0.05f;       // a wider sub-tile is never culled
constexpr float kSkyErr = 4e-6f;         // rad, over a sample's sky->pixel rounding
constexpr float kMinCosFar = 0.05f;      // caps reaching this near the horizon are kept

// A sub-tile's centre pixel and the padded cap (radius r, rad) around it
// that holds every pixel of the sub-tile.  state: 0 no live pixel, 1
// cullable, 2 never culled (a wide or non-finite cap).
struct SubTile {
  float ra_r, sin_dec, cos_dec;
  float x, y, z;
  float r, cos_r, sin_r;
  int state;
};

__device__ __forceinline__ void unit_vector(float ra_r, float sin_dec, float cos_dec, float& x,
                                            float& y, float& z) {
  x = cos_dec * cosf(ra_r);
  y = cos_dec * sinf(ra_r);
  z = sin_dec;
}

// Once per block: the four sub-tiles' centres and caps, into shared `sub`.
__device__ void tile_caps(SubTile* sub, unsigned* chord_bits, const PixelSky& px,
                          const float* __restrict__ gra, const float* __restrict__ gdec, int q) {
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  if (tid < kSub) {
    SubTile& t = sub[tid];
    const int col0 = blockIdx.x * kTileX + tid * kSubW;
    const int row0 = blockIdx.y * kTileY;
    t.state = col0 < q ? 1 : 0;
    const int col = min(col0 + kSubW / 2 - 1, q - 1);   // a live pixel of the sub-tile
    const int row = min(row0 + kTileY / 2 - 1, q - 1);
    const int64_t o = static_cast<int64_t>(row) * q + col;
    t.ra_r = gra[o] * kDeg2Rad;
    const float dec_r = gdec[o] * kDeg2Rad;
    t.sin_dec = sinf(dec_r);
    t.cos_dec = cosf(dec_r);
    unit_vector(t.ra_r, t.sin_dec, t.cos_dec, t.x, t.y, t.z);
    chord_bits[tid] = 0u;
  }
  __syncthreads();
  const int k = threadIdx.x / kSubW;
  float chord = 0.0f;
  if (px.live) {
    float x, y, z;
    unit_vector(px.ra_r, px.sin_dec, px.cos_dec, x, y, z);
    const float dx = x - sub[k].x, dy = y - sub[k].y, dz = z - sub[k].z;
    chord = sqrtf(dx * dx + dy * dy + dz * dz);
    if (!(chord <= kMaxChord)) chord = 1.0f;   // NaN too: never culled
  }
#pragma unroll
  for (int off = kSubW / 2; off > 0; off >>= 1)
    chord = fmaxf(chord, __shfl_xor_sync(0xffffffffu, chord, off));
  // Non-negative floats order as their bits.
  if ((threadIdx.x & (kSubW - 1)) == 0) atomicMax(&chord_bits[k], __float_as_uint(chord));
  __syncthreads();
  if (tid < kSub) {
    SubTile& t = sub[tid];
    const float c = __uint_as_float(chord_bits[tid]);
    if (t.state == 1 && !(c <= kMaxChord)) t.state = 2;
    // The arc 2 asin(c / 2) is at most 1.0002 c for c <= 0.05.
    t.r = c * 1.01f + kSkyErr;
    t.cos_r = cosf(t.r);
    t.sin_r = sinf(t.r);
  }
  __syncthreads();
}

// True only if no pixel of the block's tile can sample slot c's frame
// (H, W) inside [0, W-1] x [0, H-1]: the bound of the header.
__device__ bool misses_tile(const SlotConst& c, const SubTile* sub, int h, int w) {
  const float adet = fabsf(c.det);
  const float lx = (fabsf(c.cd22) + fabsf(c.cd12)) / adet * kRad2Deg;   // px per radian
  const float ly = (fabsf(c.cd21) + fabsf(c.cd11)) / adet * kRad2Deg;
  if (!(isfinite(lx) && isfinite(ly))) return false;   // det 0 or non-finite WCS
  for (int k = 0; k < kSub; ++k) {
    const SubTile& t = sub[k];
    if (t.state == 0) continue;
    if (t.state == 2) return false;
    float sx, sy, cosc;
    sky_to_src(c, t.ra_r, t.sin_dec, t.cos_dec, sx, sy, cosc);
    const float sin_c = sqrtf(fmaxf(1.0f - cosc * cosc, 0.0f));
    const float cos_far = cosc * t.cos_r - sin_c * t.sin_r;   // cos(theta_c + r)
    if (!(cos_far > kMinCosFar && fabsf(sx) < 1e30f && fabsf(sy) < 1e30f)) return false;
    const float stretch = 1.01f * t.r / (cos_far * cos_far);
    const float slack = 1.0f + 2e-5f * (fabsf(sx) + fabsf(sy));
    const float ex = stretch * lx + slack;
    const float ey = stretch * ly + slack;
    if (sx + ex >= 0.0f && sx - ex <= static_cast<float>(w - 1) && sy + ey >= 0.0f &&
        sy - ey <= static_cast<float>(h - 1))
      return false;
  }
  return true;
}

// warp_project, culled (see the header): a block walks chunks of up to
// kThreads images over its tile.  A slot with a finite accept whose
// footprint misses the tile writes the select's +0 (vm and m) times a, as
// the unculled kernel does there, without sampling.
__global__ void __launch_bounds__(kThreads)
    warp_project_kernel(const float* __restrict__ pixels, const float* __restrict__ wcs,
                        const float* __restrict__ accept, const float* __restrict__ gra,
                        const float* __restrict__ gdec, float* __restrict__ tile,
                        float* __restrict__ cov, int n_img, int h, int w, int q) {
  __shared__ SlotConst slots[kThreads];
  __shared__ unsigned char culled[kThreads];
  __shared__ SubTile sub[kSub];
  __shared__ unsigned chord_bits[kSub];
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const PixelSky px = pixel_sky(gra, gdec, q);
  tile_caps(sub, chord_bits, px, gra, gdec, q);
  const int64_t plane = static_cast<int64_t>(h) * w;
  const int64_t qq = static_cast<int64_t>(q) * q;
  for (int n0 = blockIdx.z * kThreads; n0 < n_img; n0 += gridDim.z * kThreads) {
    const int n = min(kThreads, n_img - n0);
    __syncthreads();  // the previous chunk's slots are no longer read
    if (tid < n) {
      const float a = accept[n0 + tid];
      const SlotConst c = make_slot(wcs + static_cast<int64_t>(n0 + tid) * 8, a);
      slots[tid] = c;
      culled[tid] = isfinite(a) && misses_tile(c, sub, h, w);
    }
    __syncthreads();
    if (!px.live) continue;
    for (int j = 0; j < n; ++j) {
      float vm = 0.0f, m = 0.0f;
      if (!culled[j])   // block-uniform
        warp_sample(pixels + (n0 + j) * plane, h, w, slots[j], px.ra_r, px.sin_dec,
                    px.cos_dec, vm, m);
      const float a = slots[j].a;
      const int64_t at = (n0 + j) * qq + px.o;
      __stcs(tile + at, vm * a);
      __stcs(cov + at, m * a);
    }
  }
}

// Ranks a predicate block-wide, in thread order: -> this thread's rank
// among the threads whose `pred` is set; `total` is their count.  One
// barrier.  `warp_n` is the caller's buffer of kWarps counts: two calls in
// a row need two buffers, since a warp may write the second's counts
// before another has read the first's.
__device__ __forceinline__ int block_rank(bool pred, int* warp_n, int& total) {
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, pred);
  if (lane == 0) warp_n[warp] = __popc(ballot);
  __syncthreads();
  int base = 0;
  total = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    base += k < warp ? warp_n[k] : 0;
    total += warp_n[k];
  }
  return base + __popc(ballot & ((1u << lane) - 1u));
}

// The culled pass, for query blockIdx.z of the batch: candidates, footprint
// tests and sampling over the whole scan (see the header).
template <class Acc>
__global__ void __launch_bounds__(kThreads, Acc::kMinBlocks)
    pack_scan_kernel(const float* __restrict__ pixels, const float* __restrict__ wcs,
                     const int* __restrict__ pack_idx, const float* __restrict__ accepts,
                     const unsigned char* __restrict__ finite, const float* __restrict__ gras,
                     const float* __restrict__ gdecs, const typename Acc::Args batch_args,
                     int n_packs, int cap, int h, int w, int q) {
  // Candidates waiting for their footprint test, in scan order: fewer than
  // kThreads carried over plus one round.
  __shared__ int cand_g[2 * kThreads];     // scan position: the row of pack_idx
  __shared__ int cand_s[2 * kThreads];     // slot in the pack
  __shared__ float cand_a[2 * kThreads];   // accept
  // The slots one footprint round kept, in scan order.
  __shared__ SlotConst kept[kThreads];
  __shared__ const float* kept_img[kThreads];
  __shared__ int kept_g[kThreads];
  __shared__ int warp_n[2][kWarps];
  __shared__ SubTile sub[kSub];
  __shared__ unsigned chord_bits[kSub];
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  // This block's query: its grids, accept rows and output planes.
  const int64_t qq = static_cast<int64_t>(q) * q;
  const float* gra = gras + blockIdx.z * qq;
  const float* gdec = gdecs + blockIdx.z * qq;
  const float* accept = accepts + static_cast<int64_t>(blockIdx.z) * n_packs * cap;
  const PixelSky px = pixel_sky(gra, gdec, q);
  tile_caps(sub, chord_bits, px, gra, gdec, q);
  const int64_t plane = static_cast<int64_t>(h) * w;
  Acc acc;
  if (px.live) acc.load(Acc::query(batch_args, blockIdx.z, qq), px.o);
  int buf = 0;         // which warp_n the next block_rank takes
  int n_cand = 0;      // candidates waiting
  int open_g = -1;     // the scan position whose partial is open, or -1
  // (g0, s0): the scan position and slot of the round's first slot.
  for (int g0 = 0, s0 = 0; g0 < n_packs;) {
    // 1. Candidates: rule (a), no trig.
    int s = s0 + tid;
    const int g = g0 + s / cap;
    s -= (g - g0) * cap;
    bool cand = false;
    float a = 0.0f;
    if (g < n_packs) {
      a = accept[static_cast<int64_t>(g) * cap + s];
      cand = !(a == 0.0f && finite != nullptr &&
               finite[static_cast<int64_t>(pack_idx[g]) * cap + s] != 0);
    }
    int total;
    const int at = n_cand + block_rank(cand, warp_n[buf], total);
    buf ^= 1;
    if (cand) {
      cand_g[at] = g;
      cand_s[at] = s;
      cand_a[at] = a;
    }
    n_cand += total;
    s0 += kThreads;
    g0 += s0 / cap;
    s0 %= cap;
    // 2-3. Footprint tests of kThreads candidates, or of the last ones,
    // then the kept slots sampled.
    while (n_cand >= kThreads || (g0 >= n_packs && n_cand > 0)) {
      __syncthreads();  // the candidates are written; the last kept list is no longer read
      const int n = min(kThreads, n_cand);
      bool keep = false;
      SlotConst c;
      const float* img = nullptr;
      int cg = 0;
      if (tid < n) {
        cg = cand_g[tid];
        const int64_t slot = static_cast<int64_t>(pack_idx[cg]) * cap + cand_s[tid];
        const float ca = cand_a[tid];
        c = make_slot(wcs + slot * 8, ca);
        // (b): a finite accept times a sample outside the frame adds +-0.
        keep = !(isfinite(ca) && misses_tile(c, sub, h, w));
        img = pixels + slot * plane;
      }
      int n_kept;
      const int k_at = block_rank(keep, warp_n[buf], n_kept);
      buf ^= 1;
      if (keep) {
        kept[k_at] = c;
        kept_img[k_at] = img;
        kept_g[k_at] = cg;
      }
      // The untested candidates move to the front: each thread read its own
      // entry before block_rank's barrier, and n_cand - n < n here.
      if (tid < n_cand - n) {
        cand_g[tid] = cand_g[n + tid];
        cand_s[tid] = cand_s[n + tid];
        cand_a[tid] = cand_a[n + tid];
      }
      n_cand -= n;
      __syncthreads();  // the kept list and the moved candidates are written
      if (px.live) {
        for (int j = 0; j < n_kept; ++j) {
          const int gj = kept_g[j];   // block-uniform
          if (gj != open_g) {
            if (open_g >= 0) acc.end_pack();
            acc.begin_pack();
            open_g = gj;
          }
          float vm, m;
          warp_sample(kept_img[j], h, w, kept[j], px.ra_r, px.sin_dec, px.cos_dec, vm, m);
          acc.add(vm, m, kept[j].a);
        }
      }
    }
  }
  if (px.live) {
    if (open_g >= 0) acc.end_pack();
    acc.store(Acc::query(batch_args, blockIdx.z, qq), px.o);
  }
}

// The unculled pass (the check form, one query): pack by pack, in chunks
// of kThreads slots, every slot staged and sampled.
template <class Acc>
__global__ void __launch_bounds__(kThreads)
    pack_scan_unculled_kernel(const float* __restrict__ pixels, const float* __restrict__ wcs,
                              const int* __restrict__ pack_idx,
                              const float* __restrict__ accept, const float* __restrict__ gra,
                              const float* __restrict__ gdec, const typename Acc::Args args,
                              int n_packs, int cap, int h, int w, int q) {
  __shared__ SlotConst slots[kThreads];
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const PixelSky px = pixel_sky(gra, gdec, q);
  const int64_t plane = static_cast<int64_t>(h) * w;
  Acc acc;
  if (px.live) acc.load(args, px.o);
  for (int g = 0; g < n_packs; ++g) {
    const int64_t first_slot = static_cast<int64_t>(pack_idx[g]) * cap;
    acc.begin_pack();
    for (int s0 = 0; s0 < cap; s0 += kThreads) {
      const int n = min(kThreads, cap - s0);
      __syncthreads();  // the previous chunk's slots are no longer read
      if (tid < n)
        slots[tid] = make_slot(wcs + (first_slot + s0 + tid) * 8,
                               accept[static_cast<int64_t>(g) * cap + s0 + tid]);
      __syncthreads();
      if (px.live) {
        const float* img = pixels + (first_slot + s0) * plane;
        for (int j = 0; j < n; ++j) {
          float vm, m;
          warp_sample(img + j * plane, h, w, slots[j], px.ra_r, px.sin_dec, px.cos_dec, vm,
                      m);
          acc.add(vm, m, slots[j].a);
        }
      }
    }
    acc.end_pack();
  }
  if (px.live) acc.store(args, px.o);
}

dim3 pixel_grid(int q, int z) {
  return dim3((q + kTileX - 1) / kTileX, (q + kTileY - 1) / kTileY, z);
}

// The scan operands every pass shares; accept and the grids hold n_queries
// queries' rows and planes.
struct Scan {
  const float* pixels;
  const float* wcs;
  const int* pack_idx;
  const float* accept;
  const unsigned char* finite;
  const float* gra;
  const float* gdec;
  int n_queries, n_packs, cap, h, w, q, device;
  void* stream;
};

// The culled pass over n_queries queries, or the unculled one (one query).
template <class Acc>
int launch_scan(const Scan& s, const typename Acc::Args& args, bool culled) {
  cudaError_t err = cudaSetDevice(s.device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t stream = static_cast<cudaStream_t>(s.stream);
  if (culled)
    pack_scan_kernel<Acc><<<pixel_grid(s.q, s.n_queries), dim3(kTileX, kTileY), 0, stream>>>(
        s.pixels, s.wcs, s.pack_idx, s.accept, s.finite, s.gra, s.gdec, args, s.n_packs, s.cap,
        s.h, s.w, s.q);
  else
    pack_scan_unculled_kernel<Acc><<<pixel_grid(s.q, 1), dim3(kTileX, kTileY), 0, stream>>>(
        s.pixels, s.wcs, s.pack_idx, s.accept, s.gra, s.gdec, args, s.n_packs, s.cap, s.h, s.w,
        s.q);
  return static_cast<int>(cudaGetLastError());
}

// One pass of either form.  kind 0 coadd_fused (out0 coadd, out1 depth), 1
// coadd_moments (out0..2 = S0, S1, S2), 2 coadd_clip (in0 centre, in1
// radius, out0 coadd, out1 depth), 3 coadd_hist (in0 lo, in1 inv_w, out0
// the (nbins, Q, Q) histogram; nbins 8, 16 or 32).  Each in and out is
// (n_queries, ...) for a batch.
int launch_kind(int kind, int nbins, const Scan& s, const float* in0, const float* in1,
                float* out0, float* out1, float* out2, bool culled) {
  const int64_t qq = static_cast<int64_t>(s.q) * s.q;
  switch (kind * 64 + (kind == 3 ? nbins : 0)) {
    case 0:
      return launch_scan<SumAcc>(s, {out0, out1}, culled);
    case 64:
      return launch_scan<MomentsAcc>(s, {out0, out1, out2}, culled);
    case 128:
      return launch_scan<ClipAcc>(s, {in0, in1, out0, out1}, culled);
    case 192 + 8:
      return launch_scan<HistAcc<8>>(s, {in0, in1, out0, qq}, culled);
    case 192 + 16:
      return launch_scan<HistAcc<16>>(s, {in0, in1, out0, qq}, culled);
    case 192 + 32:
      return launch_scan<HistAcc<32>>(s, {in0, in1, out0, qq}, culled);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Each launches on `stream` (a
// cudaStream_t, e.g. torch.cuda.current_stream().cuda_stream) of `device`,
// does not synchronise, and returns the cudaError_t of the launch.

extern "C" int warp_project_f32(const float* pixels, const float* wcs, const float* accept,
                                const float* gra, const float* gdec, float* tile, float* cov,
                                int n_img, int h, int w, int q, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunks = (n_img + kThreads - 1) / kThreads;
  warp_project_kernel<<<pixel_grid(q, chunks < 65535 ? chunks : 65535), dim3(kTileX, kTileY), 0,
                        static_cast<cudaStream_t>(stream)>>>(pixels, wcs, accept, gra, gdec,
                                                             tile, cov, n_img, h, w, q);
  return static_cast<int>(cudaGetLastError());
}

// The unculled warp_project (operands as warp_project_f32): the check form
// chip_smoke.py holds the culled kernel against, bitwise.  No wrapper
// launches it.
extern "C" int warp_project_unculled_f32(const float* pixels, const float* wcs,
                                         const float* accept, const float* gra,
                                         const float* gdec, float* tile, float* cov, int n_img,
                                         int h, int w, int q, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int z = n_img < 65535 ? n_img : 65535;
  warp_project_unculled_kernel<<<pixel_grid(q, z), dim3(kTileX, kTileY), 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      pixels, wcs, accept, gra, gdec, tile, cov, n_img, h, w, q);
  return static_cast<int>(cudaGetLastError());
}

// The unculled form of any pass (`kind` and operands as launch_kind;
// `finite` is not read): the check chip_smoke.py holds the culled passes
// against, bitwise.  No wrapper launches it.
extern "C" int pack_scan_unculled_f32(int kind, int nbins, const float* pixels,
                                      const float* wcs, const int* pack_idx,
                                      const float* accept, const float* gra, const float* gdec,
                                      const float* in0, const float* in1, float* out0,
                                      float* out1, float* out2, int n_packs, int cap, int h,
                                      int w, int q, int device, void* stream) {
  const Scan s{pixels, wcs, pack_idx, accept, nullptr, gra, gdec, 1, n_packs, cap, h, w, q,
               device, stream};
  return launch_kind(kind, nbins, s, in0, in1, out0, out1, out2, false);
}

// The culled pass of any kind (`kind`, `nbins` and operands as launch_kind)
// for n_queries queries in ONE launch, query k in blockIdx.z: accept
// (n_queries, n_packs, cap), the grids, in0, in1 and every output n_queries
// planes (or histograms) one after another; n_queries = 1 is the one-query
// pass.  `finite` is the (packs, cap) uint8 slot flag of the header's rule
// (a), indexed like the pixels' slots; null skips no rejected slot.
// n_queries must be in [1, 65535] and nbins one of 8, 16, 32 (the wrappers
// check); anything else returns cudaErrorInvalidValue and launches nothing.
extern "C" int pack_scan_f32(int kind, int nbins, const float* pixels, const float* wcs,
                             const int* pack_idx, const float* accept,
                             const unsigned char* finite, const float* gra, const float* gdec,
                             const float* in0, const float* in1, float* out0, float* out1,
                             float* out2, int n_queries, int n_packs, int cap, int h, int w,
                             int q, int device, void* stream) {
  if (n_queries < 1 || n_queries > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Scan s{pixels, wcs, pack_idx, accept, finite, gra, gdec, n_queries, n_packs, cap, h, w,
               q, device, stream};
  return launch_kind(kind, nbins, s, in0, in1, out0, out1, out2, true);
}

extern "C" const char* warp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
