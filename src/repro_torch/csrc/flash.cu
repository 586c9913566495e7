// Hopper (sm_90a) kernels of attention with an online softmax: the forward
// (below) and its backward (the flash_bwd_* kernels, further down).
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
// skipped.  Given an `lse` pointer (training), each row's log-sum-exp of
// its scaled logits, m + log l in natural units, is also written; O is the
// same either way.
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
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, Strides sq, Strides sk, Strides sv, Strides so,
                     int hq, int group, int seq, float scale, int causal, int window) {
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
    // The row's log-sum-exp of the scaled logits, for the backward pass.
    if (lse != nullptr && tx == 0)
      lse[(static_cast<long long>(blockIdx.y) * seq) + row] =
          l[i] == 0.0f ? -INFINITY : m[i] + logf(l[i]);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   Strides sq, Strides sk, Strides sv, Strides so, int batch, int hq, int hkv,
                   int seq, float scale, int causal, int window, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<D>;
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBQ - 1) / kBQ, batch * hq);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, sq, sk, sv, so, hq, hq / hkv, seq, scale, causal, window);
  return cudaGetLastError();
}

// ---- bfloat16 on the tensor cores ---------------------------------------

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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
                          float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                          Strides so, int hq, int group, int seq, float scale, int causal,
                          int window, int aligned) {
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
    // The row's log-sum-exp of the scaled logits in natural units (m is in
    // log2 units), for the backward pass.
    if (lse != nullptr && tq == 0)
      lse[static_cast<long long>(blockIdx.x) * seq + row] =
          l[i] == 0.0f ? -INFINITY : (m[i] + log2f(l[i])) * kLn2;
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                        Strides sq, Strides sk, Strides sv, Strides so, int batch, int hq,
                        int hkv, int seq, float scale, int causal, int window, int aligned,
                        cudaStream_t stream) {
  auto kernel = flash_fwd_bf16_kernel<D>;
  constexpr size_t bytes = tc_smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * hq, (seq + kTcRows - 1) / kTcRows);   // q tiles last first
  kernel<<<grid, kTcThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, sq, sk, sv, so,
      hq, hq / hkv, seq, scale, causal, window, aligned);
  return cudaGetLastError();
}

// 16-byte cp.async needs every row of q, k and v to start on 16 bytes.
bool rows_aligned(const void* p, Strides st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 8 == 0 && st.h % 8 == 0 &&
         st.s % 8 == 0;
}

// ---- the backward pass ----------------------------------------------------
//
// Replaces no TPU kernel: the JAX package differentiates its flash call in
// XLA (kernels/attention/ops.py::_bwd recomputes through mha_ref under
// jax.vjp).  These kernels compute that gradient the FlashAttention-2 way
// from the forward's O and per-row log-sum-exp (LSE), with nothing of size
// S x S in device memory:
//
//   flash_bwd_preprocess_kernel: Di = sum_d dO[i, d] * O[i, d] (float32);
//   P[i, j] = exp(s[i, j] * scale - LSE[i]) where the mask keeps (i, j),
//   else 0; dP = dO V^T; dS = P * (dP - Di);
//   flash_bwd_dkdv_kernel: dV = P^T dO and dK = scale * dS^T Q, summed over
//     the q heads of the kv head's group;
//   flash_bwd_dq_kernel: dQ = scale * dS K;
//   flash_bwd_dkdv_reduce_kernel (split grid only, below): the group's sum.
//
// Rounding (kernels/attention/ref.py::flash_bwd_ref rounds at the same
// points, so that it is the same function densely): every product of two
// operands is exact and every sum float32.  In bf16, as FlashAttention-2
// and SDPA do, P is rounded to bf16 before dV += P^T dO and dS to bf16
// before dK += dS^T Q and dQ += dS K; dS itself is P (unrounded float32)
// times (dP - Di).  In float32 nothing is rounded between the products.
// Each gradient is rounded once, to its operand's dtype, when it is stored.
// No kernel uses atomics: one block owns each output tile and walks its
// loops in a fixed order, so two runs give the same bits.
//
// bf16, on the tensor cores (mma.sync.m16n8k16, bf16 operands, float32
// accumulators, fed by ldmatrix from XOR-swizzled bf16 tiles; Q, dO, K and
// V stay bf16 in shared memory; the tiles the loop walks arrive by 16-byte
// cp.async, double-buffered: stage n + 1 loads while stage n computes):
// * dkdv: one block per (batch, kv head, 128-key tile), 8 warps each owning
//   16 keys.  It loads K and V once and walks 64-row q stages over the q
//   heads of the group.  Each warp computes the transposed scores S^T =
//   K Q^T and dP^T = V dO^T for its keys, 32 q columns at a time, so that
//   P^T and dS^T come out of the accumulators in exactly the A-fragment
//   layout that dV += P^T dO and dK += dS^T Q read (dO and Q through
//   ldmatrix.trans), with no trip through shared memory.  A warp's 16 x D
//   dK and dV accumulators take 4 D / 32 registers a thread (64 at D 128).
//   At D 256 they would take 256, so the block holds 64 keys as 4 key
//   groups x 2 column halves: the two warps of a key group each compute
//   P^T and dS^T for half the stage's q columns, share them as bf16
//   through shared memory, and each accumulates 128 of the 256 columns.
// * dq: one block per (batch, q head, 128-row q tile), 8 warps of 16 rows,
//   walking the 64-key tiles (32 at D 256) its rows can see: S = Q K^T and
//   dP = dO V^T row-wise, dS in the A-fragment layout of dQ += dS K, K's B
//   fragments by ldmatrix.trans.
// Both recompute P as ex2(s * scale * log2 e - LSE * log2 e), the
// forward's log2 units (ex2.approx: a relative error of about 2^-22, far
// below P's bf16 rounding).
//
// float32, on the CUDA cores (explicit fmaf; the library builds with
// -fmad=false; no TF32): the same loops over float32 tiles in shared
// memory, rows padded to D + 4 floats so that the 8 lanes of a 16-byte
// access fall in 8 bank groups.  Every product is an 8 x 8 register tile
// from float4 loads: 16 floats loaded feed 64 FMAs.  S and dP (warps 0-3
// and 4-7) split each tile's D sum over 4 or 8 lanes and add the lanes'
// parts in a fixed butterfly (a reduce-scatter by shuffles); P and dS go
// through shared memory to the dV and dK (or dQ) tiles, which split the
// stage's rows over warps where the tiles are fewer than 256 threads and
// add them once at the end, in slice order.  dkdv: 64 keys a block (32 at
// D 256), 32 q rows a stage, double-buffered; dq: 64 q rows a block (32 at
// D 256), 32 keys a stage, double-buffered.
//
// The grid (both dtypes): when batch * hkv * ceil(S / keys a dkdv block,
// flash_attention_bwd_key_tile) is under one and a half waves of 132
// blocks and the group is larger than 1, one dkdv block runs per (batch,
// q head, key tile) instead and writes its dK and dV sums, unscaled, to a
// float32 scratch (2, B, Hq, S, D) that the wrapper allocates;
// flash_bwd_dkdv_reduce_kernel then adds each group's partials in q-head
// order (starting from the first, no atomics), scales dK and rounds both.
// The choice is a function of the shape alone
// (kernels/attention/ops.py::bwd_split); qwen2's 2 x 4096 bf16 training
// shape takes it (2 x 2 kv heads x 32 key tiles = 128 blocks -> 768), its
// float32 does not (256 blocks: both grids took the same time).
//
// Shared memory and registers (dynamic shared memory; ptxas -v on sm_90a,
// no spills anywhere), D 64 / 128 / 256:
//   dkdv bf16 65 / 129 / 209 KB, 187 / 246 / 247 registers;
//   dq bf16   64 / 128 / 192 KB, 208 / 239 / 245;
//   dkdv f32  86 / 150 / 205 KB, 254 at every D;
//   dq f32    86 / 150 / 204 KB, 254;
//   one block of 8 warps an SM; reduce 48 registers, preprocess 29-30.
//
// What bounds each kernel: bf16 dkdv and dq run mma.sync at about 200
// TFLOP/s at qwen2's shape, fed by ~0.6 ldmatrix.x4 (512 bytes of shared
// memory) an MMA: a warp owns 16 keys (16 rows in dq) because its 16 x D
// accumulators stay in registers, so every warp re-reads the stage's Q and
// dO (K and V in dq); with the float32 softmax work between the products
// and 8 warps an SM to hide their latency, neither the tensor cores nor
// shared memory is saturated.  wgmma, asynchronous and reading B from
// shared memory itself, with producer and consumer warps, is the next
// step.  float32 dkdv and dq: the FMA pipes and shared-memory bandwidth
// together (4 FMAs a loaded float is the SM's balance point).  The
// reduction and the preprocessing are bound by bytes.

constexpr int kBwdThreads = 256;   // 8 warps, every backward kernel

// Keys a dkdv block owns (bf16: 16 a warp; D 256: 4 key groups x 2 column
// halves) and the float32 tile.  flash_attention_bwd_key_tile hands the
// dkdv tile to the grid rule (kernels/attention/ops.py::bwd_split).
template <int D>
__host__ __device__ constexpr int bf16_dkdv_keys() { return D == 256 ? 64 : 128; }
template <int D>
__host__ __device__ constexpr int bf16_dq_keys() { return D == 256 ? 32 : 64; }
template <int D>
__host__ __device__ constexpr int f32_tile() { return D == 256 ? 32 : 64; }
constexpr int kBf16BQ = 64;      // q rows a bf16 dkdv stage holds
constexpr int kBf16QC = 32;      // q columns a warp's S^T fragments cover at once
constexpr int kBf16DqRows = 128; // q rows a bf16 dq block owns
constexpr int kF32Stage = 32;    // q rows a float32 dkdv stage, keys a dq stage

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Whether the mask keeps the pair (q row qpos, key kpos).
__device__ __forceinline__ bool keep_pair(int qpos, int kpos, int seq, int causal, int window) {
  bool keep = qpos < seq && kpos < seq;
  if (causal) keep = keep && kpos <= qpos;
  if (window > 0) keep = keep && kpos > qpos - window;
  return keep;
}
// Whether the mask removes every pair of rows [q_lo, q_hi] x keys [k_lo,
// k_hi], and whether it removes some pair.
__device__ __forceinline__ bool all_masked(int q_lo, int q_hi, int k_lo, int k_hi, int seq,
                                           int causal, int window) {
  return q_lo >= seq || k_lo >= seq || (causal && k_lo > q_hi) ||
         (window > 0 && k_hi <= q_lo - window);
}
__device__ __forceinline__ bool any_masked(int q_lo, int q_hi, int k_lo, int k_hi, int seq,
                                           int causal, int window) {
  return q_hi >= seq || k_hi >= seq || (causal && k_hi > q_lo) ||
         (window > 0 && k_lo <= q_hi - window);
}

// Di = sum_d dO[i, d] * O[i, d]: one warp a row, lanes over d, a fixed
// butterfly order.  delta is contiguous (B, Hq, S) float32.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_preprocess_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                                float* __restrict__ delta, Strides so, Strides sdo, int hq,
                                int seq, int d, long long rows) {
  const long long row = static_cast<long long>(blockIdx.x) * (kBwdThreads / 32) +
                        (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long bh = row / seq;
  const int i = static_cast<int>(row % seq);
  const int b = static_cast<int>(bh / hq);
  const int h = static_cast<int>(bh % hq);
  const T* orow = o + b * so.b + h * so.h + i * so.s;
  const T* drow = dout + b * sdo.b + h * sdo.h + i * sdo.s;
  float acc = 0.0f;
  for (int c = lane; c < d; c += 32) acc = __fmaf_rn(to_f32(drow[c]), to_f32(orow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---- bf16 on the tensor cores ----

// A warp's 16 keys (kw ..) x NJ * 8 q columns (c0 ..) of one stage: S^T =
// K Q^T and dP^T = V dO^T, then P^T and dS^T rounded to bf16 in the
// A-fragment layout (pa[j][i]: keys g + 8 i, q columns 8 j + 2 tq, + 1).
// cL holds the stage's LSE * log2 e, cDl its Di.
template <int D, int NJ>
__device__ __forceinline__ void bwd_scores_t(const __nv_bfloat16* sK, const __nv_bfloat16* sV,
                                             const __nv_bfloat16* cQ,
                                             const __nv_bfloat16* cdO, const float* cL,
                                             const float* cDl, int kw, int c0, int q0, int k0,
                                             int seq, float scale2, int causal, int window,
                                             int lane, uint32_t (&pa)[NJ][2],
                                             uint32_t (&sa)[NJ][2]) {
  float s[NJ][4], dp[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = 0.0f;
      dp[j][e] = 0.0f;
    }
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t ak[4], av[4];
    ldmatrix_x4(ak, sK + swz<D>(kw + (lane & 15), kk + (lane >> 4) * 8));
    ldmatrix_x4(av, sV + swz<D>(kw + (lane & 15), kk + (lane >> 4) * 8));
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      const int r = c0 + j * 8 + (lane & 7) + (lane >> 4) * 8;
      const int c = kk + ((lane >> 3) & 1) * 8;
      uint32_t bq[4], bo[4];
      ldmatrix_x4(bq, cQ + swz<D>(r, c));
      mma_bf16(s[j], ak, bq[0], bq[1]);
      mma_bf16(s[j + 1], ak, bq[2], bq[3]);
      ldmatrix_x4(bo, cdO + swz<D>(r, c));
      mma_bf16(dp[j], av, bo[0], bo[1]);
      mma_bf16(dp[j + 1], av, bo[2], bo[3]);
    }
  }
  const int g = lane >> 2;
  const int tq = lane & 3;
  const bool edge = any_masked(q0 + c0, q0 + c0 + 8 * NJ - 1, k0 + kw, k0 + kw + 15, seq,
                               causal, window);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = c0 + 8 * j + 2 * tq + (e & 1);   // q row within the stage
      p[e] = ex2(__fmaf_rn(s[j][e], scale2, -cL[col]));
      if (edge && !keep_pair(q0 + col, k0 + kw + g + 8 * (e >> 1), seq, causal, window))
        p[e] = 0.0f;
      ds[e] = p[e] * (dp[j][e] - cDl[col]);
    }
    pa[j][0] = pack_bf16(p[0], p[1]);
    pa[j][1] = pack_bf16(p[2], p[3]);
    sa[j][0] = pack_bf16(ds[0], ds[1]);
    sa[j][1] = pack_bf16(ds[2], ds[3]);
  }
}

template <int D>
constexpr size_t bf16_dkdv_smem() {   // K, V; Q, dO double-buffered; (D 256) P^T, dS^T; LSE, Di
  return sizeof(__nv_bfloat16) * (2 * bf16_dkdv_keys<D>() * D + 4 * kBf16BQ * D +
                                  (D == 256 ? 2 * bf16_dkdv_keys<D>() * kBf16BQ : 0)) +
         sizeof(float) * 4 * kBf16BQ;
}

// flash_bwd_dkdv_kernel's body in bf16 (below).
template <int D>
__device__ __forceinline__ void dkdv_bf16(const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv,
    float* __restrict__ part, Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
    Strides sdv, int hq, int hkv, int seq, float scale, int causal, int window, int aligned) {
  constexpr int BK = bf16_dkdv_keys<D>();
  constexpr int BQ = kBf16BQ;
  constexpr int QC = kBf16QC;
  constexpr int NJ = QC / 8;
  constexpr int CS = D == 256 ? 2 : 1;   // column splits of dK and dV
  constexpr int DW = D / CS;             // columns a warp accumulates
  constexpr int KG = 8 / CS;             // 16-key groups
  constexpr int NA = DW / 8;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(bwd_smem);   // [BK][D]
  __nv_bfloat16* sV = sK + BK * D;                                  // [BK][D]
  __nv_bfloat16* sQ = sV + BK * D;                                  // [2][BQ][D]
  __nv_bfloat16* sdO = sQ + 2 * BQ * D;                             // [2][BQ][D]
  __nv_bfloat16* sP = sdO + 2 * BQ * D;                             // [BK][BQ], D 256
  __nv_bfloat16* sdS = sP + (CS == 2 ? BK * BQ : 0);                // [BK][BQ], D 256
  float* sL = reinterpret_cast<float*>(sdS + (CS == 2 ? BK * BQ : 0));   // [2][BQ]
  float* sDl = sL + 2 * BQ;                                              // [2][BQ]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int kw = (warp % KG) * 16;   // the warp's first key in the tile
  const int cs = warp / KG;          // its column half (D 256)
  const int group = hq / hkv;
  const bool split = part != nullptr;
  int b, hk, h0, nh;
  if (split) {
    b = blockIdx.x / hq;
    h0 = blockIdx.x % hq;
    hk = h0 / group;
    nh = 1;
  } else {
    b = blockIdx.x / hkv;
    hk = blockIdx.x % hkv;
    h0 = hk * group;
    nh = group;
  }
  const int k0 = blockIdx.y * BK;   // the causal tiles with the most q rows start first
  const float scale2 = scale * kLog2e;

  // The q rows that may see some key of this tile; stages outside are skipped.
  const int k_last = min(k0 + BK, seq) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(seq - 1, k_last + window - 1) : seq - 1;
  const int t_lo = q_lo / BQ;
  const int nt = q_hi / BQ - t_lo + 1;
  const int stages = nh * nt;

  auto load_stage = [&](int n, int buf) {   // stage n: q head h0 + n / nt, q tile t_lo + n % nt
    const int h = h0 + n / nt;
    const int q0 = (t_lo + n % nt) * BQ;
    load_tile<D>(sQ + buf * BQ * D, q + b * sq.b + h * sq.h, sq.s, q0, BQ, seq, aligned, tid);
    load_tile<D>(sdO + buf * BQ * D, dout + b * sdo.b + h * sdo.h, sdo.s, q0, BQ, seq, aligned,
                 tid);
    if (tid < BQ) {
      const long long rb = (static_cast<long long>(b) * hq + h) * seq;
      const bool in = q0 + tid < seq;
      sL[buf * BQ + tid] = in ? lse[rb + q0 + tid] * kLog2e : 0.0f;
      sDl[buf * BQ + tid] = in ? delta[rb + q0 + tid] : 0.0f;
    }
  };

  load_tile<D>(sK, k + b * sk.b + hk * sk.h, sk.s, k0, BK, seq, aligned, tid);
  load_tile<D>(sV, v + b * sv.b + hk * sv.h, sv.s, k0, BK, seq, aligned, tid);
  load_stage(0, 0);
  cp_async_commit();

  float adk[NA][4], adv[NA][4];
#pragma unroll
  for (int j = 0; j < NA; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      adk[j][e] = 0.0f;
      adv[j][e] = 0.0f;
    }

  for (int n = 0; n < stages; ++n) {
    const int buf = n & 1;
    cp_async_wait<0>();
    __syncthreads();   // stage n has landed; every warp is done with stage n - 1
    if (n + 1 < stages) {
      load_stage(n + 1, buf ^ 1);
      cp_async_commit();
    }
    const int q0 = (t_lo + n % nt) * BQ;
    const __nv_bfloat16* cQ = sQ + buf * BQ * D;
    const __nv_bfloat16* cdO = sdO + buf * BQ * D;
    const float* cL = sL + buf * BQ;
    const float* cDl = sDl + buf * BQ;
    if constexpr (CS == 1) {
#pragma unroll 1
      for (int c0 = 0; c0 < BQ; c0 += QC) {
        if (all_masked(q0 + c0, q0 + c0 + QC - 1, k0 + kw, k0 + kw + 15, seq, causal, window))
          continue;
        uint32_t pa[NJ][2], sa[NJ][2];
        bwd_scores_t<D, NJ>(sK, sV, cQ, cdO, cL, cDl, kw, c0, q0, k0, seq, scale2, causal,
                            window, lane, pa, sa);
        // dV += P^T dO, dK += dS^T Q over the chunk's q rows.
#pragma unroll
        for (int kk = 0; kk < QC / 16; ++kk) {
          const uint32_t ap[4] = {pa[2 * kk][0], pa[2 * kk][1], pa[2 * kk + 1][0],
                                  pa[2 * kk + 1][1]};
          const uint32_t as[4] = {sa[2 * kk][0], sa[2 * kk][1], sa[2 * kk + 1][0],
                                  sa[2 * kk + 1][1]};
          const int r = c0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int j = 0; j < NA; j += 2) {
            const int c = j * 8 + (lane >> 4) * 8;
            uint32_t bo[4], bq[4];
            ldmatrix_x4_trans(bo, cdO + swz<D>(r, c));
            mma_bf16(adv[j], ap, bo[0], bo[1]);
            mma_bf16(adv[j + 1], ap, bo[2], bo[3]);
            ldmatrix_x4_trans(bq, cQ + swz<D>(r, c));
            mma_bf16(adk[j], as, bq[0], bq[1]);
            mma_bf16(adk[j + 1], as, bq[2], bq[3]);
          }
        }
      }
    } else {
      // The warp's 16 keys x its half of the stage's q columns -> P^T and
      // dS^T (bf16) in shared memory, for both warps of its key group.
      const int c0 = cs * QC;
      if (all_masked(q0 + c0, q0 + c0 + QC - 1, k0 + kw, k0 + kw + 15, seq, causal, window)) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int at = swz<BQ>(kw + g + 8 * i, c0 + 8 * j + 2 * tq);
            *reinterpret_cast<uint32_t*>(sP + at) = 0u;
            *reinterpret_cast<uint32_t*>(sdS + at) = 0u;
          }
      } else {
        uint32_t pa[NJ][2], sa[NJ][2];
        bwd_scores_t<D, NJ>(sK, sV, cQ, cdO, cL, cDl, kw, c0, q0, k0, seq, scale2, causal,
                            window, lane, pa, sa);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int at = swz<BQ>(kw + g + 8 * i, c0 + 8 * j + 2 * tq);
            *reinterpret_cast<uint32_t*>(sP + at) = pa[j][i];
            *reinterpret_cast<uint32_t*>(sdS + at) = sa[j][i];
          }
      }
      __syncthreads();   // both halves of every key group's P^T and dS^T are in
      if (!all_masked(q0, q0 + BQ - 1, k0 + kw, k0 + kw + 15, seq, causal, window)) {
#pragma unroll 1
        for (int kk = 0; kk < BQ / 16; ++kk) {
          uint32_t ap[4], as[4];
          ldmatrix_x4(ap, sP + swz<BQ>(kw + (lane & 15), kk * 16 + (lane >> 4) * 8));
          ldmatrix_x4(as, sdS + swz<BQ>(kw + (lane & 15), kk * 16 + (lane >> 4) * 8));
          const int r = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int j = 0; j < NA; j += 2) {
            const int c = cs * DW + j * 8 + (lane >> 4) * 8;
            uint32_t bo[4], bq[4];
            ldmatrix_x4_trans(bo, cdO + swz<D>(r, c));
            mma_bf16(adv[j], ap, bo[0], bo[1]);
            mma_bf16(adv[j + 1], ap, bo[2], bo[3]);
            ldmatrix_x4_trans(bq, cQ + swz<D>(r, c));
            mma_bf16(adk[j], as, bq[0], bq[1]);
            mma_bf16(adk[j + 1], as, bq[2], bq[3]);
          }
        }
      }
    }
  }

  const long long plane = static_cast<long long>(gridDim.x) * seq * D;   // split: B * Hq * S * D
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + kw + g + 8 * i;
    if (key >= seq) continue;
#pragma unroll
    for (int j = 0; j < NA; ++j) {
      const int col = cs * DW + 8 * j + 2 * tq;
      if (split) {
        float* pk = part + ((static_cast<long long>(b) * hq + h0) * seq + key) * D + col;
        *reinterpret_cast<float2*>(pk) = make_float2(adk[j][2 * i], adk[j][2 * i + 1]);
        *reinterpret_cast<float2*>(pk + plane) = make_float2(adv[j][2 * i], adv[j][2 * i + 1]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dk + b * sdk.b + hk * sdk.h + key * sdk.s + col) =
            __floats2bfloat162_rn(adk[j][2 * i] * scale, adk[j][2 * i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + b * sdv.b + hk * sdv.h + key * sdv.s + col) =
            __floats2bfloat162_rn(adv[j][2 * i], adv[j][2 * i + 1]);
      }
    }
  }
}

template <int D>
constexpr size_t bf16_dq_smem() {   // Q, dO; K, V double-buffered
  return sizeof(__nv_bfloat16) * (2 * kBf16DqRows * D + 4 * bf16_dq_keys<D>() * D);
}

// flash_bwd_dq_kernel's body in bf16.
template <int D>
__device__ __forceinline__ void dq_bf16(const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, Strides sq, Strides sk,
    Strides sv, Strides sdo, Strides sdq, int hq, int hkv, int seq, float scale, int causal,
    int window, int aligned) {
  constexpr int BQ = kBf16DqRows;
  constexpr int BK = bf16_dq_keys<D>();
  constexpr int NS = BK / 8;
  constexpr int ND = D / 8;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(bwd_smem);   // [BQ][D]
  __nv_bfloat16* sdO = sQ + BQ * D;                                 // [BQ][D]
  __nv_bfloat16* sK = sdO + BQ * D;                                 // [2][BK][D]
  __nv_bfloat16* sV = sK + 2 * BK * D;                              // [2][BK][D]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * 16;   // the warp's first row in the q tile
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int b = blockIdx.x / hq;
  const int h = blockIdx.x % hq;
  const int hk = h / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // q tiles last first
  const int row_lo = q0 + r0;
  const float scale2 = scale * kLog2e;
  const __nv_bfloat16* kb = k + b * sk.b + hk * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + hk * sv.h;

  const int q_last = min(q0 + BQ, seq) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? q_last : seq - 1;
  const int t_lo = k_lo / BK;
  const int t_hi = k_hi / BK;

  load_tile<D>(sQ, q + b * sq.b + h * sq.h, sq.s, q0, BQ, seq, aligned, tid);
  load_tile<D>(sdO, dout + b * sdo.b + h * sdo.h, sdo.s, q0, BQ, seq, aligned, tid);
  load_tile<D>(sK, kb, sk.s, t_lo * BK, BK, seq, aligned, tid);
  load_tile<D>(sV, vb, sv.s, t_lo * BK, BK, seq, aligned, tid);
  cp_async_commit();

  float l2[2], dl[2];   // rows g and g + 8 of the warp: LSE * log2 e, Di
  const long long rb = (static_cast<long long>(b) * hq + h) * seq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_lo + g + 8 * i;
    l2[i] = row < seq ? lse[rb + row] * kLog2e : 0.0f;
    dl[i] = row < seq ? delta[rb + row] : 0.0f;
  }
  float adq[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[j][e] = 0.0f;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int buf = (t - t_lo) & 1;
    cp_async_wait<0>();
    __syncthreads();   // tile t has landed; every warp is done with tile t - 1
    if (t < t_hi) {
      load_tile<D>(sK + (buf ^ 1) * BK * D, kb, sk.s, (t + 1) * BK, BK, seq, aligned, tid);
      load_tile<D>(sV + (buf ^ 1) * BK * D, vb, sv.s, (t + 1) * BK, BK, seq, aligned, tid);
      cp_async_commit();
    }
    const int k0 = t * BK;
    if (all_masked(row_lo, row_lo + 15, k0, k0 + BK - 1, seq, causal, window)) continue;
    const __nv_bfloat16* cK = sK + buf * BK * D;
    const __nv_bfloat16* cV = sV + buf * BK * D;

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = 0.0f;
        dp[j][e] = 0.0f;
      }
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t aq[4], ao[4];
      ldmatrix_x4(aq, sQ + swz<D>(r0 + (lane & 15), kk + (lane >> 4) * 8));
      ldmatrix_x4(ao, sdO + swz<D>(r0 + (lane & 15), kk + (lane >> 4) * 8));
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        const int r = j * 8 + (lane & 7) + (lane >> 4) * 8;
        const int c = kk + ((lane >> 3) & 1) * 8;
        uint32_t bk[4], bv[4];
        ldmatrix_x4(bk, cK + swz<D>(r, c));
        mma_bf16(s[j], aq, bk[0], bk[1]);
        mma_bf16(s[j + 1], aq, bk[2], bk[3]);
        ldmatrix_x4(bv, cV + swz<D>(r, c));
        mma_bf16(dp[j], ao, bv[0], bv[1]);
        mma_bf16(dp[j + 1], ao, bv[2], bv[3]);
      }
    }
    const bool edge = any_masked(row_lo, row_lo + 15, k0, k0 + BK - 1, seq, causal, window);
    uint32_t sa[NS][2];   // dS in bf16, rows g and g + 8
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = ex2(__fmaf_rn(s[j][e], scale2, -l2[i]));
        if (edge && !keep_pair(row_lo + g + 8 * i, k0 + 8 * j + 2 * tq + (e & 1), seq, causal,
                               window))
          p = 0.0f;
        ds[e] = p * (dp[j][e] - dl[i]);
      }
      sa[j][0] = pack_bf16(ds[0], ds[1]);
      sa[j][1] = pack_bf16(ds[2], ds[3]);
    }
    // dQ += dS K: K's B fragments come transposed by ldmatrix.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {sa[2 * kk][0], sa[2 * kk][1], sa[2 * kk + 1][0],
                             sa[2 * kk + 1][1]};
      const int r = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int j = 0; j < ND; j += 2) {
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, cK + swz<D>(r, j * 8 + (lane >> 4) * 8));
        mma_bf16(adq[j], a, bk[0], bk[1]);
        mma_bf16(adq[j + 1], a, bk[2], bk[3]);
      }
    }
  }

  __nv_bfloat16* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_lo + g + 8 * i;
    if (row >= seq) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dqb + row * sdq.s + 8 * j + 2 * tq) =
          __floats2bfloat162_rn(adq[j][2 * i] * scale, adq[j][2 * i + 1] * scale);
  }
}

// ---- float32 on the CUDA cores ----

// Rows pos0 .. pos0 + rows - 1 of one float32 (batch, head) slice into a
// shared tile of row stride D + 4: 16-byte cp.async where the operands
// allow it, else element by element; rows at or past seq are zeros.
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, long long ld,
                                              int pos0, int rows, int seq, bool aligned,
                                              int tid) {
  constexpr int LD = D + 4;
  constexpr int kChunks = D / 4;
  for (int e = tid; e < rows * kChunks; e += kBwdThreads) {
    const int r = e / kChunks;
    const int c = (e % kChunks) * 4;
    float* d = dst + r * LD + c;
    const int pos = pos0 + r;
    if (pos >= seq) {
      *reinterpret_cast<float4*>(d) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else if (aligned) {
      cp_async16(d, src + pos * ld + c);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = src[pos * ld + c + i];
    }
  }
}

// Phase A of a float32 stage, an 8 x 8 tile of A B^T over this lane's
// slice of D: acc[8 i + j] = sum_d A[ag + NA i][d] * B[8 bg + j][d], both
// tiles of row stride D + 4.  The KS slices of a tile are lanes s * R + t
// (t < R = 8 / KS the tile's place among the R tiles of its 8 lanes, which
// share B's rows and take consecutive ag): slice s reads the 16-byte
// chunks R s + (i % R) + 8 (i / R), so that the 8 lanes of each access hit
// 8 bank groups.
template <int D, int KS, int NA>
__device__ __forceinline__ void nt_tile(float (&acc)[64], const float* A, const float* B,
                                        int ag, int bg, int s) {
  constexpr int LD = D + 4;
  constexpr int R = 8 / KS;
  constexpr int STEPS = D / 4 / KS;
#pragma unroll
  for (int x = 0; x < 64; ++x) acc[x] = 0.0f;
#pragma unroll 1
  for (int i = 0; i < STEPS; ++i) {
    const int c = 4 * (R * s + (i % R) + 8 * (i / R));
    float4 bv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      bv[j] = *reinterpret_cast<const float4*>(B + (8 * bg + j) * LD + c);
#pragma unroll
    for (int ii = 0; ii < 8; ++ii) {
      const float4 a = *reinterpret_cast<const float4*>(A + (ag + NA * ii) * LD + c);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float t = acc[8 * ii + j];
        t = __fmaf_rn(a.x, bv[j].x, t);
        t = __fmaf_rn(a.y, bv[j].y, t);
        t = __fmaf_rn(a.z, bv[j].z, t);
        acc[8 * ii + j] = __fmaf_rn(a.w, bv[j].w, t);
      }
    }
  }
}

// One round of reduce_scatter: lanes whose bit M is set keep the upper
// LEN elements, the others the lower, each adding its partner's half.
template <int M, int LEN>
__device__ __forceinline__ void reduce_round(float (&acc)[64], int lane) {
  const bool up = (lane & M) != 0;
#pragma unroll
  for (int x = 0; x < LEN; ++x) {
    const float send = up ? acc[x] : acc[x + LEN];
    const float keep = up ? acc[x + LEN] : acc[x];
    acc[x] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

// Adds a tile's KS slices (lane bits 8 / KS .. 4) in a fixed butterfly,
// each round keeping half: slice s ends with elements [64 / KS s,
// 64 / KS (s + 1)) of the sum, in acc[0 .. 64 / KS).
template <int KS>
__device__ __forceinline__ void reduce_scatter(float (&acc)[64], int lane) {
  if constexpr (KS >= 2) reduce_round<4, 32>(acc, lane);
  if constexpr (KS >= 4) reduce_round<2, 16>(acc, lane);
  if constexpr (KS >= 8) reduce_round<1, 8>(acc, lane);
}

// Column j of a phase-C tile of column group cg: 4 cg .. + 3, then
// 4 (cg + D / 8) .. + 3.
template <int D>
__device__ __forceinline__ int tile_col(int cg, int j) {
  return j < 4 ? 4 * cg + j : 4 * (cg + D / 8) + j - 4;
}

// Phase C: an 8 x 8 tile acc[8 i + j] += sum over rows r = r0, r0 + STEP
// .. < ROWS of A[r][8 rg + i] * B[r][c(j)], A of row stride PS, B of D + 4;
// the tile's columns are 4 cg .. + 3 and 4 (cg + D / 8) .. + 3.
template <int D, int PS, int STEP, int ROWS>
__device__ __forceinline__ void tn_tile(float (&acc)[64], const float* A, const float* B, int rg,
                                        int cg, int r0) {
  constexpr int LD = D + 4;
#pragma unroll 2
  for (int r = r0; r < ROWS; r += STEP) {
    const float4 a0 = *reinterpret_cast<const float4*>(A + r * PS + 8 * rg);
    const float4 a1 = *reinterpret_cast<const float4*>(A + r * PS + 8 * rg + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(B + r * LD + 4 * cg);
    const float4 b1 = *reinterpret_cast<const float4*>(B + r * LD + 4 * (cg + D / 8));
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bw[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[8 * i + j] = __fmaf_rn(av[i], bw[j], acc[8 * i + j]);
  }
}

// Adds the phase-C tiles of KSC row slices (thread groups of `n` threads,
// slice `ks`, place `t`) into slice 0's, in slice order, through `scratch`
// ((KSC - 1) * n * 64 floats).  Every thread of the block calls it.
template <int KSC>
__device__ __forceinline__ void slice_sum(float (&acc)[64], float* scratch, int n, int ks,
                                          int t) {
  if constexpr (KSC > 1) {
    __syncthreads();   // the last stage's readers of scratch's memory are done
    if (ks > 0) {
#pragma unroll
      for (int x = 0; x < 64; ++x) scratch[((ks - 1) * 64 + x) * n + t] = acc[x];
    }
    __syncthreads();
    if (ks == 0) {
#pragma unroll 1
      for (int o = 1; o < KSC; ++o)
#pragma unroll
        for (int x = 0; x < 64; ++x) acc[x] += scratch[((o - 1) * 64 + x) * n + t];
    }
  }
}

template <int D>
constexpr size_t f32_dkdv_smem() {   // K, V; Q, dO double-buffered; P, dS; LSE, Di
  return sizeof(float) * (2 * f32_tile<D>() * (D + 4) + 4 * kF32Stage * (D + 4) +
                          2 * kF32Stage * (f32_tile<D>() + 4) + 4 * kF32Stage);
}

// flash_bwd_dkdv_kernel's body in float32.
template <int D>
__device__ __forceinline__ void dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ part, Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
    Strides sdv, int hq, int hkv, int seq, float scale, int causal, int window, int aligned) {
  constexpr int BT = f32_tile<D>();   // keys
  constexpr int BQ = kF32Stage;       // q rows a stage
  constexpr int LD = D + 4;
  constexpr int PS = BT + 4;          // sP, sdS: [BQ][PS], keys contiguous
  constexpr int NA = BT / 8;          // phase A: S^T and dP^T tiles, KS lanes each
  constexpr int NB = BQ / 8;
  constexpr int KS = 128 / (NA * NB);
  constexpr int R = 8 / KS;
  constexpr int CG = D / 8;           // phase C: dV and dK tiles, KSC row slices
  constexpr int TC = (BT / 8) * CG;
  constexpr int KSC = 256 / (2 * TC);
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  float* sK = reinterpret_cast<float*>(bwd_smem);   // [BT][LD]
  float* sV = sK + BT * LD;                          // [BT][LD]
  float* sQ = sV + BT * LD;                          // [2][BQ][LD]
  float* sdO = sQ + 2 * BQ * LD;                     // [2][BQ][LD]
  float* sP = sdO + 2 * BQ * LD;                     // [BQ][PS]
  float* sdS = sP + BQ * PS;                         // [BQ][PS]
  float* sL = sdS + BQ * PS;                         // [2][BQ]
  float* sDl = sL + 2 * BQ;                          // [2][BQ]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  // phase A: warps 0-3 S^T = K Q^T, warps 4-7 dP^T = V dO^T
  const int amat = tid >> 7;
  const int atile = (((tid & 127) >> 3) * R) + (lane & 7) % R;
  const int ag = atile % NA;
  const int abg = atile / NA;
  const int as = (lane & 7) / R;
  // phase C: dV (mat 0) and dK (mat 1), KSC slices of the stage's rows
  const int cgrp = tid / TC;
  const int cmat = cgrp % 2;
  const int cks = cgrp / 2;
  const int ct = tid % TC;
  const int ccg = ct % CG;
  const int crg = ct / CG;

  const int group = hq / hkv;
  const bool split = part != nullptr;
  int b, hk, h0, nh;
  if (split) {
    b = blockIdx.x / hq;
    h0 = blockIdx.x % hq;
    hk = h0 / group;
    nh = 1;
  } else {
    b = blockIdx.x / hkv;
    hk = blockIdx.x % hkv;
    h0 = hk * group;
    nh = group;
  }
  const int k0 = blockIdx.y * BT;
  const int k_last = min(k0 + BT, seq) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(seq - 1, k_last + window - 1) : seq - 1;
  const int t_lo = q_lo / BQ;
  const int nt = q_hi / BQ - t_lo + 1;
  const int stages = nh * nt;

  auto load_stage = [&](int n, int buf) {
    const int h = h0 + n / nt;
    const int q0 = (t_lo + n % nt) * BQ;
    load_tile_f32<D>(sQ + buf * BQ * LD, q + b * sq.b + h * sq.h, sq.s, q0, BQ, seq, aligned,
                     tid);
    load_tile_f32<D>(sdO + buf * BQ * LD, dout + b * sdo.b + h * sdo.h, sdo.s, q0, BQ, seq,
                     aligned, tid);
    if (tid < BQ) {
      const long long rb = (static_cast<long long>(b) * hq + h) * seq;
      const bool in = q0 + tid < seq;
      sL[buf * BQ + tid] = in ? lse[rb + q0 + tid] : 0.0f;
      sDl[buf * BQ + tid] = in ? delta[rb + q0 + tid] : 0.0f;
    }
  };

  load_tile_f32<D>(sK, k + b * sk.b + hk * sk.h, sk.s, k0, BT, seq, aligned, tid);
  load_tile_f32<D>(sV, v + b * sv.b + hk * sv.h, sv.s, k0, BT, seq, aligned, tid);
  load_stage(0, 0);
  cp_async_commit();

  float acc_c[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) acc_c[x] = 0.0f;

  for (int n = 0; n < stages; ++n) {
    const int buf = n & 1;
    cp_async_wait<0>();
    __syncthreads();   // stage n has landed; every thread is done with stage n - 1
    if (n + 1 < stages) {
      load_stage(n + 1, buf ^ 1);
      cp_async_commit();
    }
    const int q0 = (t_lo + n % nt) * BQ;
    const float* cQ = sQ + buf * BQ * LD;
    const float* cdO = sdO + buf * BQ * LD;
    const float* cL = sL + buf * BQ;
    const float* cDl = sDl + buf * BQ;

    float acc[64];
    nt_tile<D, KS, NA>(acc, amat ? sV : sK, amat ? cdO : cQ, ag, abg, as);
    reduce_scatter<KS>(acc, lane);
    // This lane's elements: keys ag + NA i, q rows 8 abg + j.
    if (amat == 0) {
#pragma unroll
      for (int x = 0; x < 64 / KS; ++x) {
        const int key = ag + NA * (as * (8 / KS) + x / 8);
        const int qr = 8 * abg + x % 8;
        sP[qr * PS + key] = keep_pair(q0 + qr, k0 + key, seq, causal, window)
                                ? expf(acc[x] * scale - cL[qr])
                                : 0.0f;
      }
    }
    __syncthreads();   // P is complete
    if (amat == 1) {
#pragma unroll
      for (int x = 0; x < 64 / KS; ++x) {
        const int key = ag + NA * (as * (8 / KS) + x / 8);
        const int qr = 8 * abg + x % 8;
        sdS[qr * PS + key] = sP[qr * PS + key] * (acc[x] - cDl[qr]);
      }
    }
    __syncthreads();   // dS is complete
    // dV += P^T dO, dK += dS^T Q: keys 8 crg + i, columns of ccg.
    tn_tile<D, PS, KSC, BQ>(acc_c, cmat ? sdS : sP, cmat ? cQ : cdO, crg, ccg, cks);
  }
  slice_sum<KSC>(acc_c, sQ, 2 * TC, cks, cmat * TC + ct);

  if (cks != 0) return;
  const long long plane = static_cast<long long>(gridDim.x) * seq * D;   // split: B * Hq * S * D
  const float mul = cmat && !split ? scale : 1.0f;   // dK's scale, after the group's sum
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int key = k0 + 8 * crg + i;
    if (key >= seq) continue;
    float* row;
    if (split) {
      row = part + (1 - cmat) * plane + ((static_cast<long long>(b) * hq + h0) * seq + key) * D;
    } else if (cmat) {
      row = dk + b * sdk.b + hk * sdk.h + key * sdk.s;
    } else {
      row = dv + b * sdv.b + hk * sdv.h + key * sdv.s;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) row[tile_col<D>(ccg, j)] = acc_c[8 * i + j] * mul;
  }
}

template <int D>
constexpr size_t f32_dq_smem() {   // Q, dO; K, V double-buffered; P, dS; LSE, Di
  return sizeof(float) * (2 * f32_tile<D>() * (D + 4) + 4 * kF32Stage * (D + 4) +
                          2 * kF32Stage * (f32_tile<D>() + 4) + 2 * f32_tile<D>());
}

// flash_bwd_dq_kernel's body in float32.
template <int D>
__device__ __forceinline__ void dq_f32(const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, Strides sq, Strides sk, Strides sv,
    Strides sdo, Strides sdq, int hq, int hkv, int seq, float scale, int causal, int window,
    int aligned) {
  constexpr int BQ = f32_tile<D>();   // q rows
  constexpr int BK = kF32Stage;       // keys a stage
  constexpr int LD = D + 4;
  constexpr int PS = BQ + 4;          // sP, sdS: [BK][PS], q rows contiguous
  constexpr int NA = BQ / 8;          // phase A: S and dP tiles, KS lanes each
  constexpr int NB = BK / 8;
  constexpr int KS = 128 / (NA * NB);
  constexpr int R = 8 / KS;
  constexpr int CG = D / 8;           // phase C: dQ tiles, KSC key slices
  constexpr int TC = (BQ / 8) * CG;
  constexpr int KSC = 256 / TC;
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  float* sQ = reinterpret_cast<float*>(bwd_smem);   // [BQ][LD]
  float* sdO = sQ + BQ * LD;                         // [BQ][LD]
  float* sK = sdO + BQ * LD;                         // [2][BK][LD]
  float* sV = sK + 2 * BK * LD;                      // [2][BK][LD]
  float* sP = sV + 2 * BK * LD;                      // [BK][PS]
  float* sdS = sP + BK * PS;                         // [BK][PS]
  float* sL = sdS + BK * PS;                         // [BQ]
  float* sDl = sL + BQ;                              // [BQ]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int amat = tid >> 7;   // warps 0-3 S = Q K^T, warps 4-7 dP = dO V^T
  const int atile = (((tid & 127) >> 3) * R) + (lane & 7) % R;
  const int ag = atile % NA;
  const int abg = atile / NA;
  const int as = (lane & 7) / R;
  const int cks = tid / TC;
  const int ct = tid % TC;
  const int ccg = ct % CG;
  const int crg = ct / CG;

  const int b = blockIdx.x / hq;
  const int h = blockIdx.x % hq;
  const int hk = h / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // q tiles last first
  const long long rb = (static_cast<long long>(b) * hq + h) * seq;
  const float* kb = k + b * sk.b + hk * sk.h;
  const float* vb = v + b * sv.b + hk * sv.h;
  const int q_last = min(q0 + BQ, seq) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? q_last : seq - 1;
  const int t_lo = k_lo / BK;
  const int t_hi = k_hi / BK;

  load_tile_f32<D>(sQ, q + b * sq.b + h * sq.h, sq.s, q0, BQ, seq, aligned, tid);
  load_tile_f32<D>(sdO, dout + b * sdo.b + h * sdo.h, sdo.s, q0, BQ, seq, aligned, tid);
  load_tile_f32<D>(sK, kb, sk.s, t_lo * BK, BK, seq, aligned, tid);
  load_tile_f32<D>(sV, vb, sv.s, t_lo * BK, BK, seq, aligned, tid);
  cp_async_commit();
  if (tid < BQ) {
    const bool in = q0 + tid < seq;
    sL[tid] = in ? lse[rb + q0 + tid] : 0.0f;
    sDl[tid] = in ? delta[rb + q0 + tid] : 0.0f;
  }

  float acc_c[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) acc_c[x] = 0.0f;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int buf = (t - t_lo) & 1;
    cp_async_wait<0>();
    __syncthreads();   // tile t has landed; every thread is done with tile t - 1
    if (t < t_hi) {
      load_tile_f32<D>(sK + (buf ^ 1) * BK * LD, kb, sk.s, (t + 1) * BK, BK, seq, aligned, tid);
      load_tile_f32<D>(sV + (buf ^ 1) * BK * LD, vb, sv.s, (t + 1) * BK, BK, seq, aligned, tid);
      cp_async_commit();
    }
    const int k0 = t * BK;
    const float* cK = sK + buf * BK * LD;
    const float* cV = sV + buf * BK * LD;

    float acc[64];
    nt_tile<D, KS, NA>(acc, amat ? sdO : sQ, amat ? cV : cK, ag, abg, as);
    reduce_scatter<KS>(acc, lane);
    // This lane's elements: q rows ag + NA i, keys 8 abg + j.
    if (amat == 0) {
#pragma unroll
      for (int x = 0; x < 64 / KS; ++x) {
        const int qr = ag + NA * (as * (8 / KS) + x / 8);
        const int key = 8 * abg + x % 8;
        sP[key * PS + qr] = keep_pair(q0 + qr, k0 + key, seq, causal, window)
                                ? expf(acc[x] * scale - sL[qr])
                                : 0.0f;
      }
    }
    __syncthreads();   // P is complete
    if (amat == 1) {
#pragma unroll
      for (int x = 0; x < 64 / KS; ++x) {
        const int qr = ag + NA * (as * (8 / KS) + x / 8);
        const int key = 8 * abg + x % 8;
        sdS[key * PS + qr] = sP[key * PS + qr] * (acc[x] - sDl[qr]);
      }
    }
    __syncthreads();   // dS is complete
    // dQ += dS K: q rows 8 crg + i, columns of ccg.
    tn_tile<D, PS, KSC, BK>(acc_c, sdS, cK, crg, ccg, cks);
  }
  slice_sum<KSC>(acc_c, sK, TC, cks, ct);

  if (cks != 0) return;
  float* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + 8 * crg + i;
    if (row >= seq) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dqb[row * sdq.s + tile_col<D>(ccg, j)] = acc_c[8 * i + j] * scale;
  }
}

// ---- the kernels: one name a kernel, the body by dtype ----

// dK and dV of one (batch, kv head or q head, key tile); `part` null: the
// group's sum stored in the operands' dtype, else this q head's sums
// (unscaled, float32) into part[0] (dK) and part[1] (dV), (B, Hq, S, D).
template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ part,
                          Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
                          Strides sdv, int hq, int hkv, int seq, float scale, int causal,
                          int window, int aligned) {
  if constexpr (sizeof(T) == 2)
    dkdv_bf16<D>(q, k, v, dout, lse, delta, dk, dv, part, sq, sk, sv, sdo, sdk, sdv, hq, hkv, seq,
                 scale, causal, window, aligned);
  else
    dkdv_f32<D>(q, k, v, dout, lse, delta, dk, dv, part, sq, sk, sv, sdo, sdk, sdv, hq, hkv, seq,
                scale, causal, window, aligned);
}

// dQ of one (batch, q head, q tile).
template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides sdo,
                        Strides sdq, int hq, int hkv, int seq, float scale, int causal,
                        int window, int aligned) {
  if constexpr (sizeof(T) == 2)
    dq_bf16<D>(q, k, v, dout, lse, delta, dq, sq, sk, sv, sdo, sdq, hq, hkv, seq, scale, causal,
               window, aligned);
  else
    dq_f32<D>(q, k, v, dout, lse, delta, dq, sq, sk, sv, sdo, sdq, hq, hkv, seq, scale, causal,
              window, aligned);
}

// ---- the split grid's reduction ----

// dK = scale * sum_h part[0][b, h], dV = sum_h part[1][b, h] over the q heads
// h of each kv head's group, added in head order from the first; four
// columns a thread.  part is contiguous (2, B, Hq, S, D) float32.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dkdv_reduce_kernel(const float* __restrict__ part, T* __restrict__ dk,
                                 T* __restrict__ dv, Strides sdk, Strides sdv, int hq, int hkv,
                                 int seq, int d, float scale, long long n4, long long plane) {
  const long long idx = static_cast<long long>(blockIdx.x) * kBwdThreads + threadIdx.x;
  if (idx >= n4) return;
  const int d4 = d / 4;
  const int c = static_cast<int>(idx % d4) * 4;
  const long long row = idx / d4;   // (b, hk, s)
  const int s = static_cast<int>(row % seq);
  const long long bh = row / seq;
  const int hk = static_cast<int>(bh % hkv);
  const int b = static_cast<int>(bh / hkv);
  const int group = hq / hkv;
  const float* pk = part + ((static_cast<long long>(b) * hq + hk * group) * seq + s) * d + c;
  float4 ak = *reinterpret_cast<const float4*>(pk);
  float4 av = *reinterpret_cast<const float4*>(pk + plane);
  for (int hh = 1; hh < group; ++hh) {
    pk += static_cast<long long>(seq) * d;
    const float4 xk = *reinterpret_cast<const float4*>(pk);
    const float4 xv = *reinterpret_cast<const float4*>(pk + plane);
    ak.x += xk.x;
    ak.y += xk.y;
    ak.z += xk.z;
    ak.w += xk.w;
    av.x += xv.x;
    av.y += xv.y;
    av.z += xv.z;
    av.w += xv.w;
  }
  T* rk = dk + b * sdk.b + hk * sdk.h + s * sdk.s + c;
  T* rv = dv + b * sdv.b + hk * sdv.h + s * sdv.s + c;
  const float sk4[4] = {ak.x, ak.y, ak.z, ak.w};
  const float sv4[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rk[i] = from_f32<T>(sk4[i] * scale);
    rv[i] = from_f32<T>(sv4[i]);
  }
}

template <typename T>
cudaError_t launch_bwd_preprocess(const void* o, const void* dout, float* delta, Strides so,
                                  Strides sdo, int batch, int hq, int seq, int d,
                                  cudaStream_t stream) {
  const long long rows = static_cast<long long>(batch) * hq * seq;
  const long long blocks = (rows + kBwdThreads / 32 - 1) / (kBwdThreads / 32);
  flash_bwd_preprocess_kernel<T><<<static_cast<unsigned>(blocks), kBwdThreads, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, so, sdo, hq, seq, d, rows);
  return cudaGetLastError();
}

// Every row of a float32 operand starts on 16 bytes (for 16-byte cp.async).
bool rows_aligned_f32(const void* p, Strides st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % 4 == 0 && st.h % 4 == 0 &&
         st.s % 4 == 0;
}

struct BwdArgs {   // the dkdv and dq launches' common operands
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  Strides sq, sk, sv, sdo;
  int batch, hq, hkv, seq, causal, window;
  float scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_bwd_dkdv_bf16(const BwdArgs& a, void* dk, void* dv, float* part, Strides sdk,
                                 Strides sdv) {
  auto kernel = flash_bwd_dkdv_kernel<__nv_bfloat16, D>;
  constexpr size_t bytes = bf16_dkdv_smem<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int aligned = rows_aligned(a.q, a.sq) && rows_aligned(a.k, a.sk) &&
                      rows_aligned(a.v, a.sv) && rows_aligned(a.dout, a.sdo);
  constexpr int BK = bf16_dkdv_keys<D>();
  const dim3 grid(a.batch * (part ? a.hq : a.hkv), (a.seq + BK - 1) / BK);
  using bf = __nv_bfloat16;
  kernel<<<grid, kBwdThreads, bytes, a.stream>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k), static_cast<const bf*>(a.v),
      static_cast<const bf*>(a.dout), a.lse, a.delta, static_cast<bf*>(dk), static_cast<bf*>(dv),
      part, a.sq, a.sk, a.sv, a.sdo, sdk, sdv, a.hq, a.hkv, a.seq, a.scale, a.causal, a.window,
      aligned);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_dkdv_f32(const BwdArgs& a, void* dk, void* dv, float* part, Strides sdk,
                                Strides sdv) {
  auto kernel = flash_bwd_dkdv_kernel<float, D>;
  constexpr size_t bytes = f32_dkdv_smem<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int aligned = rows_aligned_f32(a.q, a.sq) && rows_aligned_f32(a.k, a.sk) &&
                      rows_aligned_f32(a.v, a.sv) && rows_aligned_f32(a.dout, a.sdo);
  constexpr int BT = f32_tile<D>();
  const dim3 grid(a.batch * (part ? a.hq : a.hkv), (a.seq + BT - 1) / BT);
  kernel<<<grid, kBwdThreads, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(dk), static_cast<float*>(dv), part, a.sq, a.sk, a.sv, a.sdo, sdk, sdv,
      a.hq, a.hkv, a.seq, a.scale, a.causal, a.window, aligned);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_dq_bf16(const BwdArgs& a, void* dq, Strides sdq) {
  auto kernel = flash_bwd_dq_kernel<__nv_bfloat16, D>;
  constexpr size_t bytes = bf16_dq_smem<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int aligned = rows_aligned(a.q, a.sq) && rows_aligned(a.k, a.sk) &&
                      rows_aligned(a.v, a.sv) && rows_aligned(a.dout, a.sdo);
  const dim3 grid(a.batch * a.hq, (a.seq + kBf16DqRows - 1) / kBf16DqRows);
  using bf = __nv_bfloat16;
  kernel<<<grid, kBwdThreads, bytes, a.stream>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k), static_cast<const bf*>(a.v),
      static_cast<const bf*>(a.dout), a.lse, a.delta, static_cast<bf*>(dq), a.sq, a.sk, a.sv,
      a.sdo, sdq, a.hq, a.hkv, a.seq, a.scale, a.causal, a.window, aligned);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_dq_f32(const BwdArgs& a, void* dq, Strides sdq) {
  auto kernel = flash_bwd_dq_kernel<float, D>;
  constexpr size_t bytes = f32_dq_smem<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int aligned = rows_aligned_f32(a.q, a.sq) && rows_aligned_f32(a.k, a.sk) &&
                      rows_aligned_f32(a.v, a.sv) && rows_aligned_f32(a.dout, a.sdo);
  constexpr int BQ = f32_tile<D>();
  const dim3 grid(a.batch * a.hq, (a.seq + BQ - 1) / BQ);
  kernel<<<grid, kBwdThreads, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse, a.delta,
      static_cast<float*>(dq), a.sq, a.sk, a.sv, a.sdo, sdq, a.hq, a.hkv, a.seq, a.scale,
      a.causal, a.window, aligned);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_dkdv_reduce(const float* part, void* dk, void* dv, Strides sdk,
                                   Strides sdv, int batch, int hq, int hkv, int seq, int d,
                                   float scale, cudaStream_t stream) {
  const long long n4 = static_cast<long long>(batch) * hkv * seq * (d / 4);
  const long long plane = static_cast<long long>(batch) * hq * seq * d;
  const long long blocks = (n4 + kBwdThreads - 1) / kBwdThreads;
  flash_bwd_dkdv_reduce_kernel<T><<<static_cast<unsigned>(blocks), kBwdThreads, 0, stream>>>(
      part, static_cast<T*>(dk), static_cast<T*>(dv), sdk, sdv, hq, hkv, seq, d, scale, n4,
      plane);
  return cudaGetLastError();
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
  const void *q, const void *k, const void *v, void *o, void *lse, long long sqb,         \
      long long sqh, long long sqs, long long skb, long long skh, long long sks,          \
      long long svb, long long svh, long long svs, long long sob, long long soh,          \
      long long sos, int batch, int hq, int hkv, int seq, int d, int causal, int window,  \
      float scale, int device, void *stream

// `lse` is null (serving: O alone, bitwise what it was before the LSE
// existed) or a contiguous (B, Hq, S) float32 tensor that receives each
// row's log-sum-exp of its scaled logits (training: the backward's input).
extern "C" int flash_attention_fwd_f32(FLASH_ARGS) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides sq{sqb, sqh, sqs}, sk{skb, skh, sks}, sv{svb, svh, svs}, so{sob, soh, sos};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (d) {
    case 64:
      err = launch<64>(q, k, v, o, l, sq, sk, sv, so, batch, hq, hkv, seq, scale, causal,
                       window, s);
      break;
    case 128:
      err = launch<128>(q, k, v, o, l, sq, sk, sv, so, batch, hq, hkv, seq, scale, causal,
                        window, s);
      break;
    case 256:
      err = launch<256>(q, k, v, o, l, sq, sk, sv, so, batch, hq, hkv, seq, scale, causal,
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
  float* l = static_cast<float*>(lse);
  switch (d) {
    case 64:
      err = launch_bf16<64>(q, k, v, o, l, sq, sk, sv, so, batch, hq, hkv, seq, scale, causal,
                            window, aligned, s);
      break;
    case 128:
      err = launch_bf16<128>(q, k, v, o, l, sq, sk, sv, so, batch, hq, hkv, seq, scale,
                             causal, window, aligned, s);
      break;
    case 256:
      err = launch_bf16<256>(q, k, v, o, l, sq, sk, sv, so, batch, hq, hkv, seq, scale,
                             causal, window, aligned, s);
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

// The backward's entry points, one per kernel (the wrapper,
// kernels/attention/ops.py::flash_attention_bwd, calls them in order on one
// stream and counts each launch).  is_bf16 picks the operands' dtype
// (bfloat16: the tensor-core kernels, else float32: the CUDA-core ones);
// q, k, v, o, dout and the gradients are given by their (b, h, s) element
// strides with D contiguous; lse and delta are contiguous (B, Hq, S)
// float32; part is null or the split grid's contiguous (2, B, Hq, S, D)
// float32 scratch.  Each returns the cudaError_t of its launch.

namespace {

template <int D>
cudaError_t dkdv_for(const BwdArgs& a, int is_bf16, void* dk, void* dv, float* part,
                     Strides sdk, Strides sdv) {
  return is_bf16 ? launch_bwd_dkdv_bf16<D>(a, dk, dv, part, sdk, sdv)
                 : launch_bwd_dkdv_f32<D>(a, dk, dv, part, sdk, sdv);
}

template <int D>
cudaError_t dq_for(const BwdArgs& a, int is_bf16, void* dq, Strides sdq) {
  return is_bf16 ? launch_bwd_dq_bf16<D>(a, dq, sdq) : launch_bwd_dq_f32<D>(a, dq, sdq);
}

}  // namespace

extern "C" int flash_attention_bwd_preprocess(const void* o, const void* dout, void* delta,
                                              long long sob, long long soh, long long sos,
                                              long long sdob, long long sdoh, long long sdos,
                                              int batch, int hq, int seq, int d, int is_bf16,
                                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides so{sob, soh, sos}, sdo{sdob, sdoh, sdos};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dl = static_cast<float*>(delta);
  err = is_bf16 ? launch_bwd_preprocess<__nv_bfloat16>(o, dout, dl, so, sdo, batch, hq, seq, d, s)
                : launch_bwd_preprocess<float>(o, dout, dl, so, sdo, batch, hq, seq, d, s);
  return static_cast<int>(err);
}

extern "C" int flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, void* part, long long sqb, long long sqh,
    long long sqs, long long skb, long long skh, long long sks, long long svb, long long svh,
    long long svs, long long sdob, long long sdoh, long long sdos, long long sdkb,
    long long sdkh, long long sdks, long long sdvb, long long sdvh, long long sdvs, int batch,
    int hq, int hkv, int seq, int d, int causal, int window, float scale, int is_bf16,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), Strides{sqb, sqh, sqs},
                  Strides{skb, skh, sks}, Strides{svb, svh, svs}, Strides{sdob, sdoh, sdos},
                  batch, hq, hkv, seq, causal, window, scale, static_cast<cudaStream_t>(stream)};
  const Strides sdk{sdkb, sdkh, sdks}, sdv{sdvb, sdvh, sdvs};
  float* p = static_cast<float*>(part);
  switch (d) {
    case 64:
      err = dkdv_for<64>(a, is_bf16, dk, dv, p, sdk, sdv);
      break;
    case 128:
      err = dkdv_for<128>(a, is_bf16, dk, dv, p, sdk, sdv);
      break;
    case 256:
      err = dkdv_for<256>(a, is_bf16, dk, dv, p, sdk, sdv);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, long long sqb, long long sqh, long long sqs, long long skb,
    long long skh, long long sks, long long svb, long long svh, long long svs, long long sdob,
    long long sdoh, long long sdos, long long sdqb, long long sdqh, long long sdqs, int batch,
    int hq, int hkv, int seq, int d, int causal, int window, float scale, int is_bf16,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdArgs a{q, k, v, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), Strides{sqb, sqh, sqs},
                  Strides{skb, skh, sks}, Strides{svb, svh, svs}, Strides{sdob, sdoh, sdos},
                  batch, hq, hkv, seq, causal, window, scale, static_cast<cudaStream_t>(stream)};
  const Strides sdq{sdqb, sdqh, sdqs};
  switch (d) {
    case 64:
      err = dq_for<64>(a, is_bf16, dq, sdq);
      break;
    case 128:
      err = dq_for<128>(a, is_bf16, dq, sdq);
      break;
    case 256:
      err = dq_for<256>(a, is_bf16, dq, sdq);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Keys a flash_bwd_dkdv_kernel block owns at head dim d (bf16 or float32),
// or -1 for a d no kernel takes: the grid rule's one source.
extern "C" int flash_attention_bwd_key_tile(int d, int is_bf16) {
  switch (d) {
    case 64:
      return is_bf16 ? bf16_dkdv_keys<64>() : f32_tile<64>();
    case 128:
      return is_bf16 ? bf16_dkdv_keys<128>() : f32_tile<128>();
    case 256:
      return is_bf16 ? bf16_dkdv_keys<256>() : f32_tile<256>();
    default:
      return -1;
  }
}

extern "C" int flash_attention_bwd_dkdv_reduce(const void* part, void* dk, void* dv,
                                               long long sdkb, long long sdkh, long long sdks,
                                               long long sdvb, long long sdvh, long long sdvs,
                                               int batch, int hq, int hkv, int seq, int d,
                                               float scale, int is_bf16, int device,
                                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides sdk{sdkb, sdkh, sdks}, sdv{sdvb, sdvh, sdvs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(part);
  err = is_bf16 ? launch_bwd_dkdv_reduce<__nv_bfloat16>(p, dk, dv, sdk, sdv, batch, hq, hkv, seq,
                                                        d, scale, s)
                : launch_bwd_dkdv_reduce<float>(p, dk, dv, sdk, sdv, batch, hq, hkv, seq, d,
                                                scale, s);
  return static_cast<int>(err);
}
