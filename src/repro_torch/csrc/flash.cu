// Hopper (sm_90a) kernel of forward attention with an online softmax.
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
// skipped.  Products use explicit fmaf (the library builds with
// -fmad=false, which only stops the compiler from contracting).
//
// What bounds it on an H100: operations.  Causal attention at S = 2048,
// D = 64 does 4 * D flops per unmasked (q, k) pair, which on the bf16
// tensor cores (989 TFLOP/s) is far above its bytes (q, k, v, o once each).
// This first version computes on the CUDA cores in float32, 64 x 64 tiles,
// 256 threads each holding a 4 x 4 block of logits and a 4 x D/16 block of
// the accumulator; moving the two products to wgmma is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBQ = 64;          // q rows a block owns
constexpr int kBK = 64;          // keys a kv tile holds
constexpr int kThreads = 256;    // 16 x 16: rows ty*4 .. ty*4+3, columns tx + 16 j
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Element strides of one operand viewed as (B, H, S, D), D contiguous.
struct Strides {
  long long b, h, s;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, Strides sq, Strides sk,
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

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  T* ob = o + b * so.b + h * so.h;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D;
    const int c = e % D;
    const int pos = q0 + r;
    sQ[r * QS + c] = pos < seq ? to_f(qb[pos * sq.s + c]) : 0.0f;
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
      sK[r * KS + c] = in ? to_f(kb[pos * sk.s + c]) : 0.0f;
      sV[r * VS + c] = in ? to_f(vb[pos * sv.s + c]) : 0.0f;
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
        sP[(ty * 4 + i) * PS + tx + 16 * j] = to_f(from_f<T>(p));   // P in v's dtype
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
    for (int c = 0; c < NC; ++c) ob[row * so.s + tx + 16 * c] = from_f<T>(acc[i][c] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, Strides sq,
                   Strides sk, Strides sv, Strides so, int batch, int hq, int hkv, int seq,
                   float scale, int causal, int window, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + kBQ - 1) / kBQ, batch * hq);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, sv, so, hq, hq / hkv, seq, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int d, const void* q, const void* k, const void* v, void* o, Strides sq,
                     Strides sk, Strides sv, Strides so, int batch, int hq, int hkv, int seq,
                     float scale, int causal, int window, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, k, v, o, sq, sk, sv, so, batch, hq, hkv, seq, scale, causal,
                           window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, sq, sk, sv, so, batch, hq, hkv, seq, scale, causal,
                            window, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, sq, sk, sv, so, batch, hq, hkv, seq, scale, causal,
                            window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on `stream` of
// `device`, does not synchronise, and returns the cudaError_t of the launch.
// The wrapper (kernels/attention/ops.py::flash_attention) checks shapes,
// dtypes and strides: q and o are (B, Hq, S, D), k and v (B, Hkv, S, D),
// each given by its element strides (b, h, s) with D contiguous; d is 64,
// 128 or 256; hkv divides hq; window <= 0 means none; is_bf16 selects
// bfloat16 (else float32) for all four.

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   long long sqb, long long sqh, long long sqs, long long skb,
                                   long long skh, long long sks, long long svb,
                                   long long svh, long long svs, long long sob,
                                   long long soh, long long sos, int batch, int hq, int hkv,
                                   int seq, int d, int causal, int window, float scale,
                                   int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides sq{sqb, sqh, sqs}, sk{skb, skh, sks}, sv{svb, svh, svs}, so{sob, soh, sos};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? dispatch<__nv_bfloat16>(d, q, k, v, o, sq, sk, sv, so, batch, hq, hkv, seq,
                                          scale, causal, window, s)
                : dispatch<float>(d, q, k, v, o, sq, sk, sv, so, batch, hq, hkv, seq, scale,
                                  causal, window, s);
  return static_cast<int>(err);
}

extern "C" const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
