// Hopper (sm_90a) kernel of the Mamba-2 SSD chunked scan.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/ssd.py::ssd_chunked
// (:68, body _ssd_kernel :30), vmapped over (batch, head) by ssd/ops.py::ssd
// (:13) with B and C shared across heads.  The TPU walks the chunks as a
// sequential grid with the (N, P) state in VMEM scratch.  Here one block
// owns one (batch, head) and walks its chunks in a loop, with the state in
// shared memory; the block writes the final state too (the prefill hands it
// to decode), which the TPU kernel keeps in scratch and drops.
//
// It takes the log-decay log_a <= 0 that the model keeps (models/ssm.py
// _ssd_chunked: exp(dt * A) underflows float32 and log(0) poisons the TPU
// kernel's log(a)).  Per chunk, with cum the inclusive cumulative sum of
// log_a inside the chunk:
//   y_i   = sum_{j <= i} exp(cum_i - cum_j) (C_i . B_j) x_j + exp(cum_i) C_i S
//   S    <- exp(cum_last) S + sum_j exp(cum_last - cum_j) B_j x_j^T
// with the mask applied before the exp, all in float32 (no TF32), products
// as explicit fmaf.  Steps past the end of the sequence are identity steps
// (log_a = 0, B = C = x = 0), as the model pads them, and are not stored.
// A chunk longer than 64 steps runs as consecutive 64-step sub-chunks: the
// state carry makes that the same function (the SSD identity), and the
// (L, L) tile of a 256-step chunk with N = 128 would not fit in shared
// memory.  The plain version is kernels/ssd/ref.py::ssd_chunked_ref.
//
// What bounds it on an H100: operations, in float32 on the CUDA cores.  Per
// (head, chunk) it does the causal half of G x (2 P L(L+1)/2), C S and the
// state update (2 L N P each); C B^T (2 N L(L+1)/2) is needed once per
// (batch, chunk) since B and C are shared across heads.  This first version
// recomputes C B^T in every head's block (64 times at Zamba2's widths);
// sharing it across a block of heads is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kL = 64;          // steps per sub-chunk
constexpr int kP = 64;          // head dim
constexpr int kThreads = 256;   // 16 x 16: rows ty*4 .. ty*4+3, columns tx + 16 j

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int N>
constexpr size_t smem_bytes() {
  return sizeof(float) * (N * kP + 2 * kL * (N + 1) + kL * kP + kL * (kL + 1) + kL);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const float* __restrict__ la, const T* __restrict__ bm,
                    const T* __restrict__ cm, const T* __restrict__ x,
                    float* __restrict__ y, float* __restrict__ state, long long la_b,
                    long long la_t, long long b_b, long long b_t, long long c_b,
                    long long c_t, long long x_b, long long x_t, long long x_h, int nheads,
                    int seq, int chunk) {
  constexpr int NS = N + 1;      // padded row stride of B and C
  constexpr int GS = kL + 1;     // ... of G
  constexpr int NR = N / 16;     // state rows a thread owns
  extern __shared__ float smem[];
  float* sS = smem;                // [N][kP] carried state
  float* sB = sS + N * kP;         // [kL][NS]
  float* sC = sB + kL * NS;        // [kL][NS]
  float* sX = sC + kL * NS;        // [kL][kP]
  float* sG = sX + kL * kP;        // [kL][GS]  (M o C B^T)
  float* sCum = sG + kL * GS;      // [kL]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int b = blockIdx.x / nheads;
  const int h = blockIdx.x % nheads;
  const float* lab = la + b * la_b + h;
  const T* bb = bm + b * b_b;
  const T* cb = cm + b * c_b;
  const T* xb = x + b * x_b + h * x_h;

  for (int e = tid; e < N * kP; e += kThreads) sS[e] = 0.0f;

  for (int t0 = 0; t0 < seq; t0 += chunk) {
    // Load the sub-chunk; rows past the chunk or the sequence are identity steps.
    for (int e = tid; e < kL * N; e += kThreads) {
      const int r = e / N;
      const int c = e % N;
      const int t = t0 + r;
      const bool in = r < chunk && t < seq;
      sB[r * NS + c] = in ? to_f(bb[t * b_t + c]) : 0.0f;
      sC[r * NS + c] = in ? to_f(cb[t * c_t + c]) : 0.0f;
    }
    for (int e = tid; e < kL * kP; e += kThreads) {
      const int r = e / kP;
      const int c = e % kP;
      const int t = t0 + r;
      sX[e] = (r < chunk && t < seq) ? to_f(xb[t * x_t + c]) : 0.0f;
    }
    if (tid < kL) {
      const int t = t0 + tid;
      sCum[tid] = (tid < chunk && t < seq) ? lab[t * la_t] : 0.0f;
    }
    __syncthreads();
    if (tid == 0) {   // inclusive cumulative sum, in step order
      for (int r = 1; r < kL; ++r) sCum[r] += sCum[r - 1];
    }
    __syncthreads();

    // G = M o (C B^T) into shared memory; y starts as exp(cum_i) (C_i S).
    float g[4][4];
    float yacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) g[i][j] = yacc[i][j] = 0.0f;
#pragma unroll 8
    for (int n = 0; n < N; ++n) {
      float cv[4];
      float bv[4];
      float sv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = sC[(ty * 4 + i) * NS + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bv[j] = sB[(tx + 16 * j) * NS + n];
        sv[j] = sS[n * kP + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          g[i][j] = __fmaf_rn(cv[i], bv[j], g[i][j]);
          yacc[i][j] = __fmaf_rn(cv[i], sv[j], yacc[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      const float ci = sCum[row];
      const float decay_in = expf(ci);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const bool causal = col <= row;
        const float diff = causal ? ci - sCum[col] : 0.0f;   // masked before the exp
        sG[row * GS + col] = causal ? expf(diff) * g[i][j] : 0.0f;
        yacc[i][j] = yacc[i][j] * decay_in;
      }
    }
    __syncthreads();

    // y += G X over j <= i; meanwhile B becomes exp(cum_last - cum_j) B_j.
    const int j_end = ty * 4 + 4;   // G is zero past this thread's last row
    for (int j = 0; j < j_end; ++j) {
      float gv[4];
      float xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) gv[i] = sG[(ty * 4 + i) * GS + j];
#pragma unroll
      for (int c = 0; c < 4; ++c) xv[c] = sX[j * kP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) yacc[i][c] = __fmaf_rn(gv[i], xv[c], yacc[i][c]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      const int t = t0 + row;
      if (row < chunk && t < seq) {
        float* yrow = y + ((static_cast<long long>(b) * seq + t) * nheads + h) * kP;
#pragma unroll
        for (int c = 0; c < 4; ++c) yrow[tx + 16 * c] = yacc[i][c];
      }
    }
    const float cum_last = sCum[kL - 1];
    for (int e = tid; e < kL * N; e += kThreads) {
      const int r = e / N;
      sB[r * NS + e % N] *= expf(cum_last - sCum[r]);
    }
    __syncthreads();

    // S <- exp(cum_last) S + (w o B)^T X; each thread owns its NR x 4 entries.
    const float alpha_last = expf(cum_last);
    float sacc[NR][4];
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) sacc[i][c] = 0.0f;
#pragma unroll 4
    for (int j = 0; j < kL; ++j) {
      float bw[NR];
      float xv[4];
#pragma unroll
      for (int i = 0; i < NR; ++i) bw[i] = sB[j * NS + ty * NR + i];
#pragma unroll
      for (int c = 0; c < 4; ++c) xv[c] = sX[j * kP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) sacc[i][c] = __fmaf_rn(bw[i], xv[c], sacc[i][c]);
    }
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float* s = sS + (ty * NR + i) * kP + tx + 16 * c;
        *s = alpha_last * *s + sacc[i][c];
      }
    __syncthreads();   // the next sub-chunk reads S and overwrites B, C, X
  }

  float* out = state + (static_cast<long long>(b) * nheads + h) * N * kP;
  for (int e = tid; e < N * kP; e += kThreads) out[e] = sS[e];
}

template <typename T, int N>
cudaError_t launch(const float* la, const void* bm, const void* cm, const void* x, float* y,
                   float* state, const long long* st, int batch, int nheads, int seq,
                   int chunk, cudaStream_t stream) {
  auto kernel = ssd_scan_kernel<T, N>;
  constexpr size_t bytes = smem_bytes<N>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<batch * nheads, kThreads, bytes, stream>>>(
      la, static_cast<const T*>(bm), static_cast<const T*>(cm), static_cast<const T*>(x), y,
      state, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], nheads, seq,
      chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int n, const float* la, const void* bm, const void* cm, const void* x,
                     float* y, float* state, const long long* st, int batch, int nheads,
                     int seq, int chunk, cudaStream_t stream) {
  switch (n) {
    case 64:
      return launch<T, 64>(la, bm, cm, x, y, state, st, batch, nheads, seq, chunk, stream);
    case 128:
      return launch<T, 128>(la, bm, cm, x, y, state, st, batch, nheads, seq, chunk, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on `stream` of
// `device`, does not synchronise, and returns the cudaError_t of the launch.
// The wrapper (kernels/ssd/ops.py::ssd_log) checks shapes, dtypes and
// strides: log_a (B, T, H) float32 with H contiguous, B and C (B, T, N) with
// N contiguous, x (B, T, H, P) with P contiguous, all given by their element
// strides; y (B, T, H, P) and state (B, H, N, P) contiguous float32.  n is 64
// or 128, P is 64, 1 <= chunk <= 64 (the wrapper passes min(chunk, 64)),
// and is_bf16 selects bfloat16 (else float32) for B, C and x.

extern "C" int ssd_scan_fwd(const float* la, const void* bm, const void* cm, const void* x,
                            float* y, float* state, long long la_b, long long la_t,
                            long long b_b, long long b_t, long long c_b, long long c_t,
                            long long x_b, long long x_t, long long x_h, int batch,
                            int nheads, int seq, int n, int chunk, int is_bf16, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (chunk < 1 || chunk > kL) return static_cast<int>(cudaErrorInvalidValue);
  const long long st[9] = {la_b, la_t, b_b, b_t, c_b, c_t, x_b, x_t, x_h};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? dispatch<__nv_bfloat16>(n, la, bm, cm, x, y, state, st, batch, nheads, seq,
                                          chunk, s)
                : dispatch<float>(n, la, bm, cm, x, y, state, st, batch, nheads, seq, chunk,
                                  s);
  return static_cast<int>(err);
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
