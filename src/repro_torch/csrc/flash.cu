// Hopper (sm_90a) kernels of attention with an online softmax: the forward
// (below) and its backward (the three flash_bwd_* kernels, further down).
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
// jax.vjp).  These three kernels compute that gradient the FlashAttention-2
// way from the forward's O and per-row log-sum-exp (LSE), with nothing of
// size S x S in device memory:
//
//   flash_bwd_preprocess_kernel: Di = sum_d dO[i, d] * O[i, d] (float32);
//   P[i, j] = exp(s[i, j] * scale - LSE[i]) where the mask keeps (i, j),
//   else 0; dP = dO V^T; dS = P * (dP - Di);
//   flash_bwd_dkdv_kernel: dV = P^T dO and dK = scale * dS^T Q, summed over
//     the q heads of the kv head's group;
//   flash_bwd_dq_kernel: dQ = scale * dS K.
//
// Every product is a float32 fmaf on the CUDA cores from operands converted
// to float32 in shared memory (bf16 or float32 in device memory), every sum
// float32; each gradient is rounded once, to its operand's dtype, when it
// is stored.  kernels/attention/ref.py::flash_bwd_ref is the same function
// densely.  Neither kernel uses atomics: one block owns each output tile
// and walks its loop in a fixed order, so two runs give the same bits.
//
// Blocks: dkdv one per (batch, kv head, BT-key tile): it loads its K and V
// tile once, then for each q head of the group and each BT-row q tile that
// the causal/window mask lets reach the tile (the tiles entirely masked are
// skipped) recomputes S and dP and accumulates dK and dV in registers.  dq
// one per (batch, q head, BT-row q tile), walking the kv tiles its rows can
// see, as the forward does.  BT is 64, and 32 at D 256 so that the four
// float32 tiles (Q, dO, K, V; rows padded to D + 1 floats against bank
// conflicts) and P and dS fit: 162 KB at D 128, 98 KB at D 64, 137 KB at
// D 256, of the 227 KB a block may have.  256 threads as 16 x 16: a thread
// owns BT/16 rows of an S tile (rows ty * BT/16 + i, keys tx + 16 j) and
// BT/16 rows by D/16 columns (tx + 16 c) of each accumulator, at most 64
// float32 accumulators a thread.  Rows and keys past S (a ragged last
// tile) load as zeros, get P = dS = 0 and are not stored.
//
// What bounds it on an H100: operations.  The recomputation costs 14 D
// flops a kept (q, k) pair (S and dP twice, dV, dK, dQ) against the 10 D
// of the five products, and all run at the CUDA cores' float32 rate: a
// tensor-core (mma.sync / wgmma) redesign is the next step for this kernel.

constexpr int kBwdThreads = 256;

template <int D>
__host__ __device__ constexpr int bwd_tile() { return D == 256 ? 32 : 64; }

template <int D>
constexpr size_t bwd_smem_bytes() {   // Q, dO, K, V; P, dS; LSE and Di of the q rows
  return sizeof(float) * (4 * bwd_tile<D>() * (D + 1) + 2 * bwd_tile<D>() * (bwd_tile<D>() + 1) +
                          2 * bwd_tile<D>());
}

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

// Rows pos0 .. pos0 + BT - 1 of one (batch, head) slice into a float32
// shared tile of row stride D + 1; rows at or past seq are zeros.
template <typename T, int D, int BT>
__device__ __forceinline__ void load_rows_f32(float* dst, const T* src, long long ld, int pos0,
                                              int seq, int tid) {
  for (int e = tid; e < BT * D; e += kBwdThreads) {
    const int r = e / D;
    const int c = e % D;
    const int pos = pos0 + r;
    dst[r * (D + 1) + c] = pos < seq ? to_f32(src[pos * ld + c]) : 0.0f;
  }
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

// S = Q K^T and dP = dO V^T for one (q tile, k tile) pair, then P and dS
// (masked, ragged rows and keys 0) into sP / sdS.  Rows ty * RM + i, keys
// tx + 16 j of the two tiles.
template <int D, int BT>
__device__ __forceinline__ void bwd_scores(const float* sQ, const float* sdO, const float* sK,
                                           const float* sV, const float* sL, const float* sDl,
                                           float* sP, float* sdS, int q0, int k0, int seq,
                                           float scale, int causal, int window, int ty, int tx) {
  constexpr int LD = D + 1;
  constexpr int PL = BT + 1;
  constexpr int RM = BT / 16;
  float s[RM][RM];
  float dp[RM][RM];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RM; ++j) {
      s[i][j] = 0.0f;
      dp[i][j] = 0.0f;
    }
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    float qv[RM], ov[RM], kv[RM], vv[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      qv[i] = sQ[(ty * RM + i) * LD + c];
      ov[i] = sdO[(ty * RM + i) * LD + c];
      kv[i] = sK[(tx + 16 * i) * LD + c];
      vv[i] = sV[(tx + 16 * i) * LD + c];
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        s[i][j] = __fmaf_rn(qv[i], kv[j], s[i][j]);
        dp[i][j] = __fmaf_rn(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty * RM + i;
    const int qpos = q0 + r;
#pragma unroll
    for (int j = 0; j < RM; ++j) {
      const int kc = tx + 16 * j;
      const int kpos = k0 + kc;
      bool keep = qpos < seq && kpos < seq;
      if (causal) keep = keep && kpos <= qpos;
      if (window > 0) keep = keep && kpos > qpos - window;
      const float p = keep ? expf(s[i][j] * scale - sL[r]) : 0.0f;
      sP[r * PL + kc] = p;
      sdS[r * PL + kc] = p * (dp[i][j] - sDl[r]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, Strides sq, Strides sk,
                          Strides sv, Strides sdo, Strides sdk, Strides sdv, int hq, int hkv,
                          int seq, float scale, int causal, int window) {
  constexpr int BT = bwd_tile<D>();
  constexpr int LD = D + 1;
  constexpr int PL = BT + 1;
  constexpr int RM = BT / 16;
  constexpr int NC = D / 16;
  extern __shared__ float bwd_smem[];
  float* sQ = bwd_smem;            // [BT][LD]
  float* sdO = sQ + BT * LD;       // [BT][LD]
  float* sK = sdO + BT * LD;       // [BT][LD]
  float* sV = sK + BT * LD;        // [BT][LD]
  float* sP = sV + BT * LD;        // [BT][PL]
  float* sdS = sP + BT * PL;       // [BT][PL]
  float* sL = sdS + BT * PL;       // [BT]
  float* sDl = sL + BT;            // [BT]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int b = blockIdx.x / hkv;
  const int hk = blockIdx.x % hkv;
  const int group = hq / hkv;
  const int k0 = blockIdx.y * BT;   // the causal tiles with the most q rows start first

  load_rows_f32<T, D, BT>(sK, k + b * sk.b + hk * sk.h, sk.s, k0, seq, tid);
  load_rows_f32<T, D, BT>(sV, v + b * sv.b + hk * sv.h, sv.s, k0, seq, tid);

  float adk[RM][NC];
  float adv[RM][NC];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      adk[i][c] = 0.0f;
      adv[i][c] = 0.0f;
    }

  // The q rows that may see some key of this tile; q tiles outside are skipped.
  const int k_last = min(k0 + BT, seq) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(seq - 1, k_last + window - 1) : seq - 1;

  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const T* qb = q + b * sq.b + h * sq.h;
    const T* dob = dout + b * sdo.b + h * sdo.h;
    const long long rb = (static_cast<long long>(b) * hq + h) * seq;
    for (int t = q_lo / BT; t <= q_hi / BT; ++t) {
      const int q0 = t * BT;
      __syncthreads();   // the previous tile's readers are done
      load_rows_f32<T, D, BT>(sQ, qb, sq.s, q0, seq, tid);
      load_rows_f32<T, D, BT>(sdO, dob, sdo.s, q0, seq, tid);
      if (tid < BT) {
        const bool in = q0 + tid < seq;
        sL[tid] = in ? lse[rb + q0 + tid] : 0.0f;
        sDl[tid] = in ? delta[rb + q0 + tid] : 0.0f;
      }
      __syncthreads();
      bwd_scores<D, BT>(sQ, sdO, sK, sV, sL, sDl, sP, sdS, q0, k0, seq, scale, causal, window,
                        ty, tx);
      __syncthreads();   // P and dS are complete
      // dV += P^T dO, dK += dS^T Q: keys ty * RM + i, columns tx + 16 c.
#pragma unroll 2
      for (int r = 0; r < BT; ++r) {
        float pv[RM], sv_[RM], ov[NC], qv[NC];
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          pv[i] = sP[r * PL + ty * RM + i];
          sv_[i] = sdS[r * PL + ty * RM + i];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          ov[c] = sdO[r * LD + tx + 16 * c];
          qv[c] = sQ[r * LD + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            adv[i][c] = __fmaf_rn(pv[i], ov[c], adv[i][c]);
            adk[i][c] = __fmaf_rn(sv_[i], qv[c], adk[i][c]);
          }
      }
    }
  }

  T* dkb = dk + b * sdk.b + hk * sdk.h;
  T* dvb = dv + b * sdv.b + hk * sdv.h;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = k0 + ty * RM + i;
    if (row >= seq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dkb[row * sdk.s + tx + 16 * c] = from_f32<T>(adk[i][c] * scale);
      dvb[row * sdv.s + tx + 16 * c] = from_f32<T>(adv[i][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        T* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides sdo,
                        Strides sdq, int hq, int hkv, int seq, float scale, int causal,
                        int window) {
  constexpr int BT = bwd_tile<D>();
  constexpr int LD = D + 1;
  constexpr int PL = BT + 1;
  constexpr int RM = BT / 16;
  constexpr int NC = D / 16;
  extern __shared__ float bwd_smem[];
  float* sQ = bwd_smem;
  float* sdO = sQ + BT * LD;
  float* sK = sdO + BT * LD;
  float* sV = sK + BT * LD;
  float* sP = sV + BT * LD;
  float* sdS = sP + BT * PL;
  float* sL = sdS + BT * PL;
  float* sDl = sL + BT;

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int b = blockIdx.x / hq;
  const int h = blockIdx.x % hq;
  const int hk = h / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BT;   // q tiles last first
  const long long rb = (static_cast<long long>(b) * hq + h) * seq;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;

  load_rows_f32<T, D, BT>(sQ, q + b * sq.b + h * sq.h, sq.s, q0, seq, tid);
  load_rows_f32<T, D, BT>(sdO, dout + b * sdo.b + h * sdo.h, sdo.s, q0, seq, tid);
  if (tid < BT) {
    const bool in = q0 + tid < seq;
    sL[tid] = in ? lse[rb + q0 + tid] : 0.0f;
    sDl[tid] = in ? delta[rb + q0 + tid] : 0.0f;
  }

  float adq[RM][NC];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) adq[i][c] = 0.0f;

  // The keys some row of this q tile may see, as in the forward.
  const int q_last = min(q0 + BT, seq) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? q_last : seq - 1;

  for (int t = k_lo / BT; t <= k_hi / BT; ++t) {
    const int k0 = t * BT;
    __syncthreads();   // the previous tile's readers are done
    load_rows_f32<T, D, BT>(sK, kb, sk.s, k0, seq, tid);
    load_rows_f32<T, D, BT>(sV, vb, sv.s, k0, seq, tid);
    __syncthreads();
    bwd_scores<D, BT>(sQ, sdO, sK, sV, sL, sDl, sP, sdS, q0, k0, seq, scale, causal, window, ty,
                      tx);
    __syncthreads();   // dS is complete
    // dQ += dS K: rows ty * RM + i, columns tx + 16 c.
#pragma unroll 2
    for (int kk = 0; kk < BT; ++kk) {
      float sv_[RM], kv[NC];
#pragma unroll
      for (int i = 0; i < RM; ++i) sv_[i] = sdS[(ty * RM + i) * PL + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = sK[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) adq[i][c] = __fmaf_rn(sv_[i], kv[c], adq[i][c]);
    }
  }

  T* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty * RM + i;
    if (row >= seq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) dqb[row * sdq.s + tx + 16 * c] = from_f32<T>(adq[i][c] * scale);
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

template <typename T, int D>
cudaError_t launch_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dk, void* dv,
                            Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
                            Strides sdv, int batch, int hq, int hkv, int seq, float scale,
                            int causal, int window, cudaStream_t stream) {
  auto kernel = flash_bwd_dkdv_kernel<T, D>;
  constexpr size_t bytes = bwd_smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * hkv, (seq + bwd_tile<D>() - 1) / bwd_tile<D>());
  kernel<<<grid, kBwdThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), sq, sk,
      sv, sdo, sdk, sdv, hq, hkv, seq, scale, causal, window);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* dq, Strides sq,
                          Strides sk, Strides sv, Strides sdo, Strides sdq, int batch, int hq,
                          int hkv, int seq, float scale, int causal, int window,
                          cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T, D>;
  constexpr size_t bytes = bwd_smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * hq, (seq + bwd_tile<D>() - 1) / bwd_tile<D>());
  kernel<<<grid, kBwdThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), sq, sk, sv, sdo, sdq, hq,
      hkv, seq, scale, causal, window);
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
// kernels/attention/ops.py::flash_attention_bwd, calls the three in order on
// one stream and counts each launch).  is_bf16 picks the operands' dtype
// (bfloat16, else float32); q, k, v, o, dout and the gradients are given by
// their (b, h, s) element strides with D contiguous; lse and delta are
// contiguous (B, Hq, S) float32.  Each returns the cudaError_t of its launch.

namespace {

template <typename T>
cudaError_t dispatch_dkdv(int d, const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* dk, void* dv, Strides sq,
                          Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                          int batch, int hq, int hkv, int seq, float scale, int causal,
                          int window, cudaStream_t s) {
  switch (d) {
    case 64:
      return launch_bwd_dkdv<T, 64>(q, k, v, dout, lse, delta, dk, dv, sq, sk, sv, sdo, sdk,
                                    sdv, batch, hq, hkv, seq, scale, causal, window, s);
    case 128:
      return launch_bwd_dkdv<T, 128>(q, k, v, dout, lse, delta, dk, dv, sq, sk, sv, sdo, sdk,
                                     sdv, batch, hq, hkv, seq, scale, causal, window, s);
    case 256:
      return launch_bwd_dkdv<T, 256>(q, k, v, dout, lse, delta, dk, dv, sq, sk, sv, sdo, sdk,
                                     sdv, batch, hq, hkv, seq, scale, causal, window, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dq(int d, const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dq, Strides sq, Strides sk,
                        Strides sv, Strides sdo, Strides sdq, int batch, int hq, int hkv,
                        int seq, float scale, int causal, int window, cudaStream_t s) {
  switch (d) {
    case 64:
      return launch_bwd_dq<T, 64>(q, k, v, dout, lse, delta, dq, sq, sk, sv, sdo, sdq, batch,
                                  hq, hkv, seq, scale, causal, window, s);
    case 128:
      return launch_bwd_dq<T, 128>(q, k, v, dout, lse, delta, dq, sq, sk, sv, sdo, sdq, batch,
                                   hq, hkv, seq, scale, causal, window, s);
    case 256:
      return launch_bwd_dq<T, 256>(q, k, v, dout, lse, delta, dq, sq, sk, sv, sdo, sdq, batch,
                                   hq, hkv, seq, scale, causal, window, s);
    default:
      return cudaErrorInvalidValue;
  }
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
    const void* delta, void* dk, void* dv, long long sqb, long long sqh, long long sqs,
    long long skb, long long skh, long long sks, long long svb, long long svh, long long svs,
    long long sdob, long long sdoh, long long sdos, long long sdkb, long long sdkh,
    long long sdks, long long sdvb, long long sdvh, long long sdvs, int batch, int hq, int hkv,
    int seq, int d, int causal, int window, float scale, int is_bf16, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides sq{sqb, sqh, sqs}, sk{skb, skh, sks}, sv{svb, svh, svs},
      sdo{sdob, sdoh, sdos}, sdk{sdkb, sdkh, sdks}, sdv{sdvb, sdvh, sdvs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  err = is_bf16 ? dispatch_dkdv<__nv_bfloat16>(d, q, k, v, dout, l, dl, dk, dv, sq, sk, sv, sdo,
                                               sdk, sdv, batch, hq, hkv, seq, scale, causal,
                                               window, s)
                : dispatch_dkdv<float>(d, q, k, v, dout, l, dl, dk, dv, sq, sk, sv, sdo, sdk,
                                       sdv, batch, hq, hkv, seq, scale, causal, window, s);
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
  const Strides sq{sqb, sqh, sqs}, sk{skb, skh, sks}, sv{svb, svh, svs},
      sdo{sdob, sdoh, sdos}, sdq{sdqb, sdqh, sdqs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  err = is_bf16 ? dispatch_dq<__nv_bfloat16>(d, q, k, v, dout, l, dl, dq, sq, sk, sv, sdo, sdq,
                                             batch, hq, hkv, seq, scale, causal, window, s)
                : dispatch_dq<float>(d, q, k, v, dout, l, dl, dq, sq, sk, sv, sdo, sdq, batch,
                                     hq, hkv, seq, scale, causal, window, s);
  return static_cast<int>(err);
}
