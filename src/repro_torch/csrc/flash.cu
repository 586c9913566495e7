// Hopper (sm_90a) kernels of forward attention with an online softmax.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/attention/flash.py::flash_attention_single (:80, body
// _flash_kernel :33), vmapped over (batch, q head) by
// attention/ops.py::flash_attention (:23).  The TPU walks a (q tile, kv tile)
// grid in order with the running max, denominator and accumulator in VMEM
// scratch.  Here one block owns one (batch, q head, 64-row q tile) and walks
// its kv tiles itself, with those three in registers; blocks run in any
// order.  Kv head = q head / group is read in place through strides, with no
// repeat or copy, and q, k, v, o may be any strided views whose last axis is
// contiguous (the model's (B, S, H, D) activations seen as (B, H, S, D)).
//
// What it computes, as the TPU kernel does (and kernels/attention/ref.py::
// flash_ref, its plain version, densely):
//   s = (q . k) * scale in float32, masked to -1e30 where causal
//       (k > q) or the window (k <= q - window) removes the pair;
//   m' = max(m, rowmax s); p = exp(s - m'); alpha = exp(m - m');
//   l = l * alpha + sum p (p in float32);  acc = acc * alpha + P . V with P
//   rounded to v's dtype first and the product accumulated in float32;
//   o = acc / (l == 0 ? 1 : l), rounded to o's dtype.
// Unlike the TPU kernel it takes any sequence length: keys past the end of
// a ragged last tile get -inf (exactly 0 weight) and rows past it are not
// stored.  Kv tiles that the masks remove for every row of the q tile are
// skipped.
//
// What bounds it on an H100: operations.  Causal attention at S = 2048,
// D = 64 does 4 * D flops per unmasked (q, k) pair, which on the bf16
// tensor cores (989 TFLOP/s) is far above its bytes (q, k, v, o once each).
// Two kernels, chosen by dtype:
//
// * bfloat16, flash_fwd_bf16_kernel: both products on the tensor cores, as
//   mma.sync.m16n8k16 (bf16 operands, float32 accumulators) fed by ldmatrix.
//   mma.sync rather than wgmma: at D 64 the softmax's float32 work on the
//   CUDA cores (scale, mask, max, exp, sum, the bf16 rounding of P) costs
//   about as much as the products, so the products need not reach wgmma's
//   rate before the softmax bounds the kernel; and mma.sync keeps S and P in
//   the per-thread fragment layout that the softmax and the P.V product read
//   without a trip through shared memory.  8 warps a block, each owning
//   16 rows of a 128-row q tile: S = Q K^T (16 x BK a warp), the softmax on
//   its fragments (a row's values sit in the 4 lanes of a quad), P rounded to
//   bf16 straight into the A fragments of P.V, and the 16 x D accumulator in
//   registers.  The logits are kept in log2 units, s * (scale * log2 e) in
//   float32 (the masks stay at -1e30), so that p = ex2(s - m') is one
//   subtract and one ex2.approx.ftz.  Its relative error from exp(s - m')
//   grows by about 1e-7 for each unit of |s - m'|, far below the 2^-9 of
//   P's bf16 rounding wherever p matters (a p below 2^-126 flushes to 0).
//   Q, K and V stay bf16 in shared memory, their 16-byte chunks XOR-swizzled
//   by row so that ldmatrix reads no two rows from one bank group.  K and V tiles arrive by 16-byte
//   cp.async, double-buffered: tile t + 1 loads while tile t computes.
//   (Operands that are not 16-byte aligned are copied element by element
//   into the same layout.)  BK is 64 keys, and 32 at D 256, where the
//   16 x 256 accumulator takes 128 registers a thread: the q tile keeps its
//   rows and the kv tile shrinks, keeping S's fragments small and shared
//   memory at 128 KB.  A warp skips the tiles its own rows cannot see
//   (below).  Blocks are issued by q tile, last first, across every
//   (batch, head): the causal tiles with the most keys start earliest and the
//   last wave holds the shortest.
// * float32, flash_fwd_kernel: on the CUDA cores in float32 (TF32 would
//   round the operands), 64 x 64 tiles, 256 threads each
//   holding a 4 x 4 block of logits and a 4 x D/16 block of the accumulator.
//   Products use explicit fmaf (the library builds with -fmad=false, which
//   only stops the compiler from contracting).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBQ = 64;          // q rows a block owns
constexpr int kBK = 64;          // keys a kv tile holds
constexpr int kThreads = 256;    // 16 x 16: rows ty*4 .. ty*4+3, columns tx + 16 j
constexpr float kMasked = -1e30f;

// Element strides of one operand viewed as (B, H, S, D), D contiguous.
struct Strides {
  long long b, h, s;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, Strides sq, Strides sk,
                     Strides sv, Strides so, int hq, int group, int seq, float scale,
                     int causal, int window) {
  constexpr int QS = D + 1;      // padded row strides of the shared tiles
  constexpr int KS = D + 1;
  constexpr int VS = D;
  constexpr int PS = kBK + 1;
  constexpr int NC = D / 16;     // accumulator columns a thread owns
  extern __shared__ float smem[];
  float* sQ = smem;                // [kBQ][QS]
  float* sK = sQ + kBQ * QS;       // [kBK][KS]
  float* sV = sK + kBK * KS;       // [kBK][VS]
  float* sP = sV + kBK * VS;       // [kBQ][PS]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int b = blockIdx.y / hq;
  const int h = blockIdx.y % hq;
  const int hk = h / group;
  const int q0 = blockIdx.x * kBQ;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + hk * sk.h;
  const float* vb = v + b * sv.b + hk * sv.h;
  float* ob = o + b * so.b + h * so.h;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D;
    const int c = e % D;
    const int pos = q0 + r;
    sQ[r * QS + c] = pos < seq ? qb[pos * sq.s + c] : 0.0f;
  }

  float acc[4][NC];
  float m[4];
  float l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  // The keys some row of this q tile may see; tiles outside are skipped.
  const int q_last = min(q0 + kBQ, seq) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? q_last : seq - 1;

  for (int t = k_lo / kBK; t <= k_hi / kBK; ++t) {
    const int k0 = t * kBK;
    __syncthreads();   // the previous tile's readers are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D;
      const int c = e % D;
      const int pos = k0 + r;
      const bool in = pos < seq;
      sK[r * KS + c] = in ? kb[pos * sk.s + c] : 0.0f;
      sV[r * VS + c] = in ? vb[pos * sv.s + c] : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4];
      float kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = __fmaf_rn(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool keep = true;
        if (causal) keep = keep && kpos <= qpos;
        if (window > 0) keep = keep && kpos > qpos - window;
        float x = keep ? s[i][j] * scale : kMasked;
        if (kpos >= seq) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // The 16 lanes of a half-warp hold one row between them.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sP[(ty * 4 + i) * PS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] = acc[i][c] * alpha;
    }
    __syncthreads();   // P is complete

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
      float vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = sV[kk * VS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = __fmaf_rn(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= seq) continue;
    const float denom = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
    for (int c = 0; c < NC; ++c) ob[row * so.s + tx + 16 * c] = acc[i][c] / denom;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, Strides sq,
                   Strides sk, Strides sv, Strides so, int batch, int hq, int hkv, int seq,
                   float scale, int causal, int window, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<D>;
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBQ - 1) / kBQ, batch * hq);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), sq, sk, sv, so, hq, hq / hkv, seq, scale, causal, window);
  return cudaGetLastError();
}

// ---- bfloat16 on the tensor cores ---------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit, denormal results flushed to 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__host__ __device__ constexpr int tc_bk() { return D == 256 ? 32 : 64; }

constexpr int kTcWarps = 8;                 // 16 q rows each: a 128-row q tile
constexpr int kTcRows = 16 * kTcWarps;
constexpr int kTcThreads = 32 * kTcWarps;

template <int D>
constexpr size_t tc_smem_bytes() {          // Q, then K and V double-buffered, bf16
  return sizeof(__nv_bfloat16) * (kTcRows * D + 4 * tc_bk<D>() * D);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element (r, c) of a shared tile of D bf16 columns.  The row's 16-byte
// chunks are permuted by chunk ^ (r % 8), so the 8 rows one ldmatrix reads
// at one column fall in 8 different bank groups (D is a multiple of 64).
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  return r * D + ((((c >> 3) ^ (r & 7))) << 3) + (c & 7);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a . b for one 16 x 8 x 16 tile: a 16 x 16 bf16 (row), b 16 x 8 bf16
// (col), c 16 x 8 float32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows pos0 .. pos0 + rows - 1 of one (batch, head) slice into a swizzled
// tile: 16-byte cp.async where the operands allow it, else element by
// element; rows at or past seq are zeros.  Not waited for here.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long ld, int pos0, int rows, int seq,
                                          bool aligned, int tid) {
  constexpr int kChunks = D / 8;
  for (int e = tid; e < rows * kChunks; e += kTcThreads) {
    const int r = e / kChunks;
    const int c = (e % kChunks) * 8;
    __nv_bfloat16* d = dst + swz<D>(r, c);
    const int pos = pos0 + r;
    if (pos >= seq) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    } else if (aligned) {
      cp_async16(d, src + pos * ld + c);
    } else {
      const __nv_bfloat16* g = src + pos * ld + c;
#pragma unroll
      for (int i = 0; i < 8; ++i) d[i] = g[i];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                          Strides sq, Strides sk, Strides sv, Strides so, int hq, int group,
                          int seq, float scale, int causal, int window, int aligned) {
  constexpr int BQ = kTcRows;
  constexpr int BK = tc_bk<D>();
  constexpr int NS = BK / 8;       // 8-key column tiles of a warp's S
  constexpr int ND = D / 8;        // 8-wide column tiles of its accumulator
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(tc_smem);   // [BQ][D]
  __nv_bfloat16* sK = sQ + BQ * D;                                  // [2][BK][D]
  __nv_bfloat16* sV = sK + 2 * BK * D;                              // [2][BK][D]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * 16;  // the warp's first row in the q tile
  const int g = lane >> 2;         // fragment row (and row + 8)
  const int tq = lane & 3;         // fragment column pair
  const int b = blockIdx.x / hq;
  const int h = blockIdx.x % hq;
  const int hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const float scale2 = scale * kLog2e;   // logits in log2 units

  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + hk * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + hk * sv.h;
  __nv_bfloat16* ob = o + b * so.b + h * so.h;

  // The keys some row of this q tile may see; tiles outside are skipped.
  const int q_last = min(q0 + BQ, seq) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? q_last : seq - 1;
  const int t_lo = k_lo / BK;
  const int t_hi = k_hi / BK;

  load_tile<D>(sQ, qb, sq.s, q0, BQ, seq, aligned, tid);
  load_tile<D>(sK, kb, sk.s, t_lo * BK, BK, seq, aligned, tid);
  load_tile<D>(sV, vb, sv.s, t_lo * BK, BK, seq, aligned, tid);
  cp_async_commit();

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float m[2] = {kMasked, kMasked};   // rows g and g + 8 of the warp
  float l[2] = {0.0f, 0.0f};
  const int row_lo = q0 + r0;        // the warp's rows: row_lo .. row_lo + 15
  // The warp's own key range: a tile outside it is masked for each of its
  // rows, and each row has seen a key that is not (its own) before such a
  // tile or sees one after it, whose alpha = 0 removes the tile: skipping it
  // changes no bit.  Rows past seq are not stored.
  const int w_lo = window > 0 ? row_lo - window + 1 : 0;
  const int w_hi = causal ? row_lo + 15 : seq - 1;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int buf = (t - t_lo) & 1;
    if (t < t_hi) {                  // tile t + 1 loads while tile t computes
      const int nb = (buf ^ 1) * BK * D;
      load_tile<D>(sK + nb, kb, sk.s, (t + 1) * BK, BK, seq, aligned, tid);
      load_tile<D>(sV + nb, vb, sv.s, (t + 1) * BK, BK, seq, aligned, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = t * BK;
    if (row_lo >= seq || k0 > w_hi || k0 + BK - 1 < w_lo) {
      __syncthreads();
      continue;
    }
    const __nv_bfloat16* cK = sK + buf * BK * D;
    const __nv_bfloat16* cV = sV + buf * BK * D;

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, sQ + swz<D>(r0 + (lane & 15), kk + (lane >> 4) * 8));
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, cK + swz<D>(j * 8 + (lane & 7) + (lane >> 4) * 8,
                                    kk + ((lane >> 3) & 1) * 8));
        mma_bf16(s[j], a, bk[0], bk[1]);
        mma_bf16(s[j + 1], a, bk[2], bk[3]);
      }
    }

    // Scale, mask, and the online softmax on the fragments (in log2 units,
    // p = 2^(s - m) = exp(logit - max)): element e of
    // s[j] is row g + 8 * (e / 2), key k0 + 8 j + 2 tq + e % 2.
    const bool edge = (causal && k0 + BK - 1 > row_lo) ||
                      (window > 0 && k0 <= row_lo + 15 - window) || k0 + BK > seq;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale2;
        if (edge) {
          const int qpos = row_lo + g + 8 * (e >> 1);
          const int kpos = k0 + 8 * j + 2 * tq + (e & 1);
          bool keep = true;
          if (causal) keep = keep && kpos <= qpos;
          if (window > 0) keep = keep && kpos > qpos - window;
          x = keep ? x : kMasked;
          if (kpos >= seq) x = -INFINITY;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // The 4 lanes of a quad hold one row between them.
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = ex2(m[i] - m_new);
      m[i] = m_new;
    }
    float sum[2] = {0.0f, 0.0f};
    uint32_t pa[NS][2];              // P in bf16, rows g and g + 8
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float p0 = ex2(s[j][0] - m[0]);
      const float p1 = ex2(s[j][1] - m[0]);
      const float p2 = ex2(s[j][2] - m[1]);
      const float p3 = ex2(s[j][3] - m[1]);
      sum[0] += p0 + p1;
      sum[1] += p2 + p3;
      pa[j][0] = pack_bf16(p0, p1);
      pa[j][1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // acc += P . V: the A fragment of keys 16 kk .. 16 kk + 15 is S's tiles
    // 2 kk and 2 kk + 1; V's B fragments come transposed by ldmatrix.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pa[2 * kk][0], pa[2 * kk][1], pa[2 * kk + 1][0],
                             pa[2 * kk + 1][1]};
#pragma unroll
      for (int j = 0; j < ND; j += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, cV + swz<D>(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                          j * 8 + (lane >> 4) * 8));
        mma_bf16(acc[j], a, bv[0], bv[1]);
        mma_bf16(acc[j + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();   // every warp is done with this buffer before it refills
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_lo + g + 8 * i;
    if (row >= seq) continue;
    const float denom = l[i] == 0.0f ? 1.0f : l[i];
    __nv_bfloat16* orow = ob + row * so.s + 2 * tq;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * i] / denom, acc[j][2 * i + 1] / denom);
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, Strides sq,
                        Strides sk, Strides sv, Strides so, int batch, int hq, int hkv, int seq,
                        float scale, int causal, int window, int aligned, cudaStream_t stream) {
  auto kernel = flash_fwd_bf16_kernel<D>;
  constexpr size_t bytes = tc_smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * hq, (seq + kTcRows - 1) / kTcRows);   // q tiles last first
  kernel<<<grid, kTcThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), sq, sk, sv, so, hq,
      hq / hkv, seq, scale, causal, window, aligned);
  return cudaGetLastError();
}

// 16-byte cp.async needs every row of q, k and v to start on 16 bytes.
bool rows_aligned(const void* p, Strides st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 8 == 0 && st.h % 8 == 0 &&
         st.s % 8 == 0;
}

}  // namespace

// Plain C entry points, loaded with ctypes, one per dtype: float32 runs
// flash_fwd_kernel on the CUDA cores, bfloat16 flash_fwd_bf16_kernel on the
// tensor cores.  Each launches on `stream` of `device`, does not
// synchronise, and returns the cudaError_t of the launch.  The wrapper
// (kernels/attention/ops.py::flash_attention) checks shapes, dtypes and
// strides: q and o are (B, Hq, S, D), k and v (B, Hkv, S, D), each given by
// its element strides (b, h, s) with D contiguous; d is 64, 128 or 256; hkv
// divides hq; window <= 0 means none.

#define FLASH_ARGS                                                                        \
  const void *q, const void *k, const void *v, void *o, long long sqb, long long sqh,     \
      long long sqs, long long skb, long long skh, long long sks, long long svb,          \
      long long svh, long long svs, long long sob, long long soh, long long sos, int batch, \
      int hq, int hkv, int seq, int d, int causal, int window, float scale, int device,    \
      void *stream

extern "C" int flash_attention_fwd_f32(FLASH_ARGS) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides sq{sqb, sqh, sqs}, sk{skb, skh, sks}, sv{svb, svh, svs}, so{sob, soh, sos};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      err = launch<64>(q, k, v, o, sq, sk, sv, so, batch, hq, hkv, seq, scale, causal,
                              window, s);
      break;
    case 128:
      err = launch<128>(q, k, v, o, sq, sk, sv, so, batch, hq, hkv, seq, scale, causal,
                               window, s);
      break;
    case 256:
      err = launch<256>(q, k, v, o, sq, sk, sv, so, batch, hq, hkv, seq, scale, causal,
                               window, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int flash_attention_fwd_bf16(FLASH_ARGS) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides sq{sqb, sqh, sqs}, sk{skb, skh, sks}, sv{svb, svh, svs}, so{sob, soh, sos};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int aligned = rows_aligned(q, sq) && rows_aligned(k, sk) && rows_aligned(v, sv);
  switch (d) {
    case 64:
      err = launch_bf16<64>(q, k, v, o, sq, sk, sv, so, batch, hq, hkv, seq, scale, causal,
                            window, aligned, s);
      break;
    case 128:
      err = launch_bf16<128>(q, k, v, o, sq, sk, sv, so, batch, hq, hkv, seq, scale, causal,
                             window, aligned, s);
      break;
    case 256:
      err = launch_bf16<256>(q, k, v, o, sq, sk, sv, so, batch, hq, hkv, seq, scale, causal,
                             window, aligned, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

#undef FLASH_ARGS

extern "C" const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
