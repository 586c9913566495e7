// Hopper (sm_90a) kernels of the Mamba-2 SSD chunked scan.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/ssd.py::ssd_chunked
// (:68, body _ssd_kernel :30), vmapped over (batch, head) by ssd/ops.py::ssd
// (:13) with B and C shared across heads.  The TPU walks the chunks as a
// sequential grid with the (N, P) state in VMEM scratch.  Here the scan is
// split as Mamba-2's own kernels split it (Dao & Gu, arXiv:2405.21060, §7:
// chunk states, state passing, chunk scan), three launches behind one call;
// the pass also writes the final state (the prefill hands it to decode),
// which the TPU kernel keeps in scratch and drops.
//
// It takes the log-decay log_a <= 0 that the model keeps (models/ssm.py
// _ssd_chunked: exp(dt * A) underflows float32 and log(0) poisons the TPU
// kernel's log(a)).  Per chunk, with cum the inclusive cumulative sum of
// log_a inside the chunk and S the state entering it:
//   y_i   = sum_{j <= i} exp(cum_i - cum_j) (C_i . B_j) x_j + exp(cum_i) C_i S
//   S    <- exp(cum_last) S + dS,  dS = sum_j B_j (exp(cum_last - cum_j) x_j)^T
//
//   ssd_chunk_state_kernel, one block per (chunk, group of heads, batch): each
//     head's cum (in step order, as torch.cumsum sums the plain version's
//     chunks; also written to a (B, n_chunks, H, 64) scratch) and its dS
//     into a float32 scratch (B, n_chunks, H, N, P).
//   ssd_state_pass_kernel, one thread an (N, P) state entry of one (batch,
//     head): walks the chunks in order, overwrites each dS with the state entering
//     its chunk, and writes the final state (B, H, N, P).
//   ssd_chunk_scan_kernel, one block per (chunk, group of heads, batch): C
//     B^T of the chunk once (B and C are shared across heads), then per head the
//     decay mask (applied before the exp) and y = (M o C B^T) X + exp(cum)
//     (C S), written once.
//
// Everything is float32 on the CUDA cores (no TF32), products as explicit
// fmaf, in the plain version's order: its einsums sum over one index each,
// and at the Zamba2 prefill's shape the kernels give its bits.  Steps past
// the end of the sequence are identity steps (log_a = 0, B = C = x = 0), as
// the model pads them, and are not stored.  A chunk longer than 64 steps
// runs as consecutive 64-step sub-chunks: the state carry makes that the
// same function (the SSD identity), and the (L, L) tile of a 256-step chunk
// with N = 128 would not fit in shared memory.  The plain version is
// kernels/ssd/ref.py::ssd_chunked_ref.
//
// What bounds it on an H100.  Operations: float32 on the CUDA cores, per
// (batch, chunk) C B^T (2 N L(L+1)/2 causal, computed here as the full L^2
// once per group of heads); per (head, chunk) the causal half of G X
// (2 P L(L+1)/2), dS (2 L N P) and C S (2 L N P).  Bytes: the split costs
// the dS scratch written, read and rewritten, and read again, 4 B n_chunks
// H N P bytes each time (134 MB at B 4, T 2048, H 64, N 64), about 0.16 ms
// of the card's 3.35 TB/s beside y's own writes.  The chunk kernels get
// B * n_chunks * ceil(H / group) blocks; the wrapper picks the group so that
// a 1 x 1000 prefill still fills the card.  Each thread owns 4 x 4 outputs
// and reads its operands as 16-byte shared loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kL = 64;          // steps per sub-chunk
constexpr int kP = 64;          // head dim
constexpr int kThreads = 256;
constexpr int kMaxGroup = 16;   // heads a chunk block may own

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// Strides (in elements) of the operands, which may be strided views.
struct Strides {
  long long la_b, la_t, b_b, b_t, c_b, c_t, x_b, x_t, x_h;
};

// The inclusive cumulative sum of log_a over sub-chunk rows [t0, t0 + kL) of
// one (batch, head), into cum[]; identity steps past the chunk or the
// sequence.  One thread, in step order, as torch.cumsum sums the plain
// version's chunks (a shuffle scan sums in another order, and the decays
// exp(cum_i - cum_j) then differ by ulps of |cum|).
__device__ __forceinline__ void chunk_cumsum(float* cum, const float* __restrict__ la_bh,
                                             long long la_t, int t0, int chunk, int seq) {
  float run = 0.0f;
#pragma unroll 16
  for (int r = 0; r < kL; ++r) {
    run += (r < chunk && t0 + r < seq) ? la_bh[(t0 + r) * la_t] : 0.0f;
    cum[r] = run;
  }
}

// Rows [t0, t0 + kL) of a (seq, W) operand (row stride ld, W contiguous)
// as float, zero past the chunk or the sequence: kIter values a thread,
// all loaded before any is stored (a loop that stores each load before the
// next waits out one memory round trip a row).
template <int W, typename T>
struct Rows {
  static constexpr int kIter = kL * W / kThreads;
  float v[kIter];
  __device__ __forceinline__ void load(const T* __restrict__ src, long long ld, int t0, int chunk,
                                       int seq) {
#pragma unroll
    for (int k = 0; k < kIter; ++k) {
      const int e = threadIdx.x + k * kThreads;
      const int r = e / W;
      const int t = t0 + r;
      v[k] = (r < chunk && t < seq) ? to_f(src[t * ld + e % W]) : 0.0f;
    }
  }
  // dst[r][c] (row stride SW), and, when SWT > 0, dstT[c][r] (stride SWT).
  template <int SW, int SWT = 0>
  __device__ __forceinline__ void store(float* dst, float* dstT = nullptr) const {
#pragma unroll
    for (int k = 0; k < kIter; ++k) {
      const int e = threadIdx.x + k * kThreads;
      if (SW > 0) dst[(e / W) * SW + e % W] = v[k];
      if (SWT > 0) dstT[(e % W) * SWT + e / W] = v[k];
    }
  }
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

constexpr int kTS = kL + 4;   // row stride of the transposed (., kL) tiles: 16-byte rows

// Thread (ty, tx) = (tid / 16, tid % 16) owns rows ty*4 .. ty*4+3 and
// columns tx*4 .. tx*4+3 of every (64, 64) tile (C B^T, G, y), and state
// rows ty*NR .. ty*NR+NR-1 by the same 4 columns.  Each step of an inner
// product reads its 4 + 4 operands as two 16-byte shared loads: the tiles a
// thread reads down a column are stored transposed, in rows of kTS floats.

template <int N>
constexpr size_t state_smem_bytes() {
  // sB [kL][N+4]; sX [kL][kP]; sCum [kMaxGroup][kL]; sW [kL].
  return sizeof(float) * (kL * (N + 4) + kL * kP + kMaxGroup * kL + kL);
}

// Chunk states: dS = sum_j B_j (w_j x_j)^T, w_j = exp(cum_last - cum_j),
// for every head of the group; also each head's decays into cumbuf.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_chunk_state_kernel(const float* __restrict__ la, const T* __restrict__ bm,
                           const T* __restrict__ x, float* __restrict__ dstate,
                           float* __restrict__ cumbuf, const Strides st, int nheads, int seq,
                           int chunk, int group) {
  constexpr int BS = N + 4;      // row stride of B (16-byte rows)
  constexpr int NR = N / 16;     // state rows a thread owns
  extern __shared__ float smem[];
  float* sB = smem;                       // [kL][BS]
  float* sX = sB + kL * BS;               // [kL][kP]
  float* sCumAll = sX + kL * kP;          // [group][kL]
  float* sW = sCumAll + kMaxGroup * kL;   // [kL]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int c = blockIdx.x;
  const int b = blockIdx.z;
  const int h0 = blockIdx.y * group;
  const int h1 = min(h0 + group, nheads);
  const int t0 = c * chunk;
  const int n_chunks = gridDim.x;

  // Each head's cumulative log_a, one thread a head, while the others load
  // B; rows past the chunk or the sequence are identity.
  if (tid < h1 - h0) chunk_cumsum(sCumAll + tid * kL, la + b * st.la_b + h0 + tid, st.la_t, t0,
                                  chunk, seq);
  {
    Rows<N, T> rb;
    rb.load(bm + b * st.b_b, st.b_t, t0, chunk, seq);
    rb.template store<BS>(sB);
  }
  for (int h = h0; h < h1; ++h) {
    __syncthreads();   // B and the sums are in; the previous head's reads are done
    {
      Rows<kP, T> rx;
      rx.load(x + b * st.x_b + h * st.x_h, st.x_t, t0, chunk, seq);
      rx.template store<kP>(sX);
    }
    const float* sCum = sCumAll + (h - h0) * kL;
    if (tid < kL) {
      cumbuf[((static_cast<long long>(b) * n_chunks + c) * nheads + h) * kL + tid] = sCum[tid];
      sW[tid] = expf(sCum[kL - 1] - sCum[tid]);
    }
    __syncthreads();
    float sacc[NR][4];
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) sacc[i][q] = 0.0f;
#pragma unroll 2
    for (int j = 0; j < kL; ++j) {
      const float wj = sW[j];
      const float4 xv = ld4(sX + j * kP + tx * 4);
      const float xw[4] = {xv.x * wj, xv.y * wj, xv.z * wj, xv.w * wj};
      float br[NR];
#pragma unroll
      for (int i = 0; i < NR; i += 4) {
        const float4 bv = ld4(sB + j * BS + ty * NR + i);
        br[i] = bv.x;
        br[i + 1] = bv.y;
        br[i + 2] = bv.z;
        br[i + 3] = bv.w;
      }
#pragma unroll
      for (int i = 0; i < NR; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) sacc[i][q] = __fmaf_rn(br[i], xw[q], sacc[i][q]);
    }
    float* ds = dstate + ((static_cast<long long>(b) * n_chunks + c) * nheads + h) * N * kP;
#pragma unroll
    for (int i = 0; i < NR; ++i)
      *reinterpret_cast<float4*>(ds + (ty * NR + i) * kP + tx * 4) =
          make_float4(sacc[i][0], sacc[i][1], sacc[i][2], sacc[i][3]);
  }
}

// The state pass, one thread an entry of the (N, P) state of one (batch,
// head): walks the chunks in order, replaces each chunk's dS in place by the
// state S entering that chunk (0 for the first), carries
// S <- exp(cum_last) S + dS, and writes the final state.
__global__ void __launch_bounds__(kThreads)
    ssd_state_pass_kernel(float* __restrict__ dstate, const float* __restrict__ cumbuf,
                          float* __restrict__ state, int nheads, int np, int n_chunks,
                          long long total) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= total) return;
  const long long bh = e / np;     // (batch, head)
  const long long off = e % np;    // (n, p)
  const long long b = bh / nheads;
  const long long h = bh % nheads;
  constexpr int kBatch = 8;        // chunks whose loads are in flight together
  float s = 0.0f;
  for (int c0 = 0; c0 < n_chunks; c0 += kBatch) {
    float ds[kBatch];
    float cum_last[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const long long bch = (b * n_chunks + c0 + k) * nheads + h;
      const bool in = c0 + k < n_chunks;
      ds[k] = in ? dstate[bch * np + off] : 0.0f;
      cum_last[k] = in ? cumbuf[bch * kL + kL - 1] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c0 + k < n_chunks) {
        dstate[((b * n_chunks + c0 + k) * nheads + h) * np + off] = s;
        s = s * expf(cum_last[k]) + ds[k];
      }
    }
  }
  state[e] = s;
}

template <int N>
constexpr size_t scan_smem_bytes() {
  // sBt (then G^T), sCt [N][kTS]; sS [N][kP]; sX [kL][kP]; sCum [kL].
  return sizeof(float) * (2 * N * kTS + N * kP + kL * kP + kL);
}

// Chunk outputs: y = (M o C B^T) X + exp(cum) o (C S) for the state S
// entering the chunk, C B^T once for every head of the group.
// Two blocks an SM at N 64 (85 KB of shared memory each); at N 128 (136 KB)
// one fits, and all its registers are free.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads, N == 64 ? 2 : 1)
    ssd_chunk_scan_kernel(const T* __restrict__ bm, const T* __restrict__ cm,
                          const T* __restrict__ x, const float* __restrict__ s_in,
                          const float* __restrict__ cumbuf, float* __restrict__ y,
                          const Strides st, int nheads, int seq, int chunk, int group) {
  extern __shared__ float smem[];
  float* sBt = smem;               // [N][kTS]  B^T, then G^T [kL][kTS]
  float* sCt = sBt + N * kTS;      // [N][kTS]  C^T
  float* sS = sCt + N * kTS;       // [N][kP]   the state entering the chunk
  float* sX = sS + N * kP;         // [kL][kP]
  float* sCum = sX + kL * kP;      // [kL]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int c = blockIdx.x;
  const int b = blockIdx.z;
  const int h0 = blockIdx.y * group;
  const int h1 = min(h0 + group, nheads);
  const int t0 = c * chunk;
  const int n_chunks = gridDim.x;
  float* sGt = sBt;
  {
    Rows<N, T> rb, rc;
    rb.load(bm + b * st.b_b, st.b_t, t0, chunk, seq);
    rc.load(cm + b * st.c_b, st.c_t, t0, chunk, seq);
    rb.template store<0, kTS>(nullptr, sBt);
    rc.template store<0, kTS>(nullptr, sCt);
  }
  __syncthreads();

  // C B^T, kept in registers: cbt[i][j] = (C B^T)[tx*4 + j][ty*4 + i], the
  // entries this thread masks for every head and stores as one 16-byte row
  // of G^T (a row of G^T spans the lanes: no bank conflicts).
  float cbt[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) cbt[i][j] = 0.0f;
#pragma unroll 2
  for (int n = 0; n < N; ++n) {
    const float4 cv = ld4(sCt + n * kTS + tx * 4);
    const float4 bv = ld4(sBt + n * kTS + ty * 4);
    const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cbt[i][j] = __fmaf_rn(cr[j], br[i], cbt[i][j]);
  }

  for (int h = h0; h < h1; ++h) {
    const long long bch = (static_cast<long long>(b) * n_chunks + c) * nheads + h;
    __syncthreads();   // C B^T's reads of B^T, the previous head's of G, X, S, cum are done
    {
      Rows<kP, T> rx;
      rx.load(x + b * st.x_b + h * st.x_h, st.x_t, t0, chunk, seq);
      rx.template store<kP>(sX);
    }
    if (c > 0) {
      constexpr int kSIter = N * kP / (kThreads * 4);
      const float* sp = s_in + bch * N * kP;
      float4 sv[kSIter];
#pragma unroll
      for (int k = 0; k < kSIter; ++k) sv[k] = ld4(sp + (tid + k * kThreads) * 4);
#pragma unroll
      for (int k = 0; k < kSIter; ++k)
        *reinterpret_cast<float4*>(sS + (tid + k * kThreads) * 4) = sv[k];
    }
    if (tid < kL) sCum[tid] = cumbuf[bch * kL + tid];
    __syncthreads();

    // G = M o C B^T (the mask before the exp), stored transposed: this
    // thread's column col of G, rows tx*4 .. tx*4+3.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = ty * 4 + i;
      const float cc = sCum[col];
      float g[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = tx * 4 + j;
        const bool causal = col <= row;
        const float diff = causal ? sCum[row] - cc : 0.0f;
        g[j] = causal ? expf(diff) * cbt[i][j] : 0.0f;
      }
      *reinterpret_cast<float4*>(sGt + col * kTS + tx * 4) = make_float4(g[0], g[1], g[2], g[3]);
    }
    __syncthreads();

    // y = G X over j <= i, plus exp(cum_i) (C S)_i after the first chunk.
    float yacc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) yacc[i][q] = 0.0f;
    const int j_end = ty * 4 + 4;   // G is zero past this thread's last row
#pragma unroll 2
    for (int j = 0; j < j_end; ++j) {
      const float4 gv = ld4(sGt + j * kTS + ty * 4);
      const float4 xv = ld4(sX + j * kP + tx * 4);
      const float gr[4] = {gv.x, gv.y, gv.z, gv.w};
      const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) yacc[i][q] = __fmaf_rn(gr[i], xr[q], yacc[i][q]);
    }
    if (c > 0) {
      float sacc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) sacc[i][q] = 0.0f;
#pragma unroll 2
      for (int n = 0; n < N; ++n) {
        const float4 cv = ld4(sCt + n * kTS + ty * 4);
        const float4 sv = ld4(sS + n * kP + tx * 4);
        const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
        const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) sacc[i][q] = __fmaf_rn(cr[i], sr[q], sacc[i][q]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(sCum[ty * 4 + i]);
#pragma unroll
        for (int q = 0; q < 4; ++q) yacc[i][q] = yacc[i][q] + sacc[i][q] * e;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      const int t = t0 + row;
      if (row < chunk && t < seq) {
        float* yrow = y + ((static_cast<long long>(b) * seq + t) * nheads + h) * kP;
        *reinterpret_cast<float4*>(yrow + tx * 4) =
            make_float4(yacc[i][0], yacc[i][1], yacc[i][2], yacc[i][3]);
      }
    }
  }
}

template <typename T, int N>
cudaError_t launch(const float* la, const void* bm, const void* cm, const void* x, float* y,
                   float* dstate, float* cumbuf, float* state, const Strides& st, int batch,
                   int nheads, int seq, int chunk, int group, cudaStream_t stream) {
  const int n_chunks = (seq + chunk - 1) / chunk;
  auto state_k = ssd_chunk_state_kernel<T, N>;
  auto scan_k = ssd_chunk_scan_kernel<T, N>;
  constexpr size_t state_bytes = state_smem_bytes<N>();
  constexpr size_t scan_bytes = scan_smem_bytes<N>();
  cudaError_t err =
      cudaFuncSetAttribute(state_k, cudaFuncAttributeMaxDynamicSharedMemorySize, state_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(scan_k, cudaFuncAttributeMaxDynamicSharedMemorySize, scan_bytes);
  if (err != cudaSuccess) return err;
  const dim3 chunk_grid(n_chunks, (nheads + group - 1) / group, batch);
  state_k<<<chunk_grid, kThreads, state_bytes, stream>>>(
      la, static_cast<const T*>(bm), static_cast<const T*>(x), dstate, cumbuf, st, nheads, seq,
      chunk, group);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(batch) * nheads * N * kP;
  const unsigned pass_blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  ssd_state_pass_kernel<<<pass_blocks, kThreads, 0, stream>>>(dstate, cumbuf, state, nheads,
                                                              N * kP, n_chunks, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_k<<<chunk_grid, kThreads, scan_bytes, stream>>>(
      static_cast<const T*>(bm), static_cast<const T*>(cm), static_cast<const T*>(x), dstate,
      cumbuf, y, st, nheads, seq, chunk, group);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int n, const float* la, const void* bm, const void* cm, const void* x,
                     float* y, float* dstate, float* cumbuf, float* state, const Strides& st,
                     int batch, int nheads, int seq, int chunk, int group, cudaStream_t stream) {
  switch (n) {
    case 64:
      return launch<T, 64>(la, bm, cm, x, y, dstate, cumbuf, state, st, batch, nheads, seq,
                           chunk, group, stream);
    case 128:
      return launch<T, 128>(la, bm, cm, x, y, dstate, cumbuf, state, st, batch, nheads, seq,
                            chunk, group, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches ssd_chunk_state_kernel,
// ssd_state_pass_kernel and ssd_chunk_scan_kernel on `stream` of `device`,
// does not synchronise, and returns the first cudaError_t.  The wrapper
// (kernels/ssd/ops.py::ssd_log) checks shapes, dtypes and strides: log_a
// (B, T, H) float32 with H contiguous, B and C (B, T, N) with N contiguous,
// x (B, T, H, P) with P contiguous, all given by their element strides;
// y (B, T, H, P), the dS scratch (B, ceil(T / chunk), H, N, P), the decays'
// scratch (B, ceil(T / chunk), H, 64) and state (B, H, N, P) contiguous
// float32.  n is 64 or 128, P is 64, 1 <= chunk <= 64 (the wrapper passes
// min(chunk, 64)), 1 <= group <= 16 (heads a block of the chunk kernels
// owns), and is_bf16 selects bfloat16 (else float32) for B, C and x.

extern "C" int ssd_scan_fwd(const float* la, const void* bm, const void* cm, const void* x,
                            float* y, float* dstate, float* cumbuf, float* state, long long la_b,
                            long long la_t, long long b_b, long long b_t, long long c_b,
                            long long c_t, long long x_b, long long x_t, long long x_h,
                            int batch, int nheads, int seq, int n, int chunk, int group,
                            int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (chunk < 1 || chunk > kL || group < 1 || group > kMaxGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{la_b, la_t, b_b, b_t, c_b, c_t, x_b, x_t, x_h};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? dispatch<__nv_bfloat16>(n, la, bm, cm, x, y, dstate, cumbuf, state, st, batch,
                                          nheads, seq, chunk, group, s)
                : dispatch<float>(n, la, bm, cm, x, y, dstate, cumbuf, state, st, batch, nheads,
                                  seq, chunk, group, s);
  return static_cast<int>(err);
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
