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
#include <type_traits>

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

// ------------------------------------------------------------------ backward
//
// The gradient of the scan above.  The JAX package has no kernel for it (it
// differentiates models/ssm.py::_ssd_chunked in XLA), so these replace no TPU
// kernel.  Per sub-chunk and head, with dy the gradient of y, dS' that of the
// state leaving the sub-chunk, S the state entering it (the forward's dS
// scratch after its pass), G = C B^T, D_ij = dy_i . x_j,
// M_ij = exp(cum_i - cum_j) for j <= i (masked before the exp), A = M o G,
// W = M o D, e_i = exp(cum_i) and w_j = exp(cum_last - cum_j):
//   dS    = exp(cum_last) dS' + C^T (e o dy)                  (a reverse pass)
//   dx    = A^T dy + w o (B dS')
//   dC    = (sum_h W) B + sum_h e o (dy S^T)        (B and C are shared
//   dB    = (sum_h W)^T C + sum_h w o (x dS'^T)      across heads)
//   dcum  = rowsum(A o D) - colsum(A o D) + C . dC_inter - x . dx_inter, and
//           exp(cum_last) <S, dS'> + sum_j x_j . dx_inter_j at the last step,
//           with x_j . dx_inter_j = w_j B_j . (x dS'^T)_j;
//   d log_a is the reverse cumulative sum of dcum within the sub-chunk.
//
//   ssd_bwd_state_pass_kernel, one block of 8 warps per (32 state rows, head,
//     batch): walks the sub-chunks last to first from the final state's
//     gradient (0 for none), kept in registers as mma accumulators.  Per
//     sub-chunk it computes its rows of C^T (e o dy) on the tensor cores,
//     writes the carried gradient as that sub-chunk's dS' and carries
//     g <- exp(cum_last) g + C^T (e o dy).  dy, C and the decays arrive by
//     16-byte cp.async in a ring of three stages, two sub-chunks ahead, and
//     the threads that copy a stage's decays take their exp as it lands, so
//     a step waits on no load and crosses one barrier.  The chunk sums never
//     reach device memory: the (B, n_chunks, H, N, P) float32 dS' scratch is
//     written once (the two kernels it replaces wrote, read and rewrote it).
//   ssd_bwd_chunk_scan_kernel, one block per (sub-chunk, group of heads,
//     batch) of 8 warps for each 64-column slice of N (16 at N 128, whose
//     two halves run the state products of their own slice side by side):
//     G = C B^T once; per head D, A (kept in shared memory for A^T dy), the
//     group's sum of W (shared memory), dx and d log_a written; the group's
//     dB and dC of each half's slice in registers as mma accumulators
//     across the head loop, the W terms added once at the end, written once
//     as the block's partial (2, B, n_chunks, groups, 64, N).  Each head's
//     x, dy, decays, S and dS' arrive by cp.async one phase ahead of their
//     use (the next head's x, dy, decays and S during this head's dS'
//     products; dS' during dy S^T at N 64, during D and A^T dy at N 128).
//   ssd_bwd_reduce_kernel, one thread an element of dB or dC: the groups'
//     partials added in group order, written in the operands' dtype.
// No atomics: two runs give the same bits.  The forward's decays (cum) and
// chunk states are read from its scratch, which the wrapper keeps under
// grad; nothing of the forward is recomputed.
//
// Products on the tensor cores at float32 accuracy.  Every product runs as
// mma.sync.m16n8k8 with TF32 operands and float32 accumulators.  A float32
// operand a is split as hi = the TF32 rounding of a (to nearest, ties away
// from zero: cvt.rna.tf32's, done in two integer operations) and lo = the
// same rounding of a - hi (exact: -fmad=false, no fast math), and the
// product is lo.hi + hi.lo + hi.hi (3xTF32; the lo.lo term, 2^-22 of the
// product, is dropped), the tiles of a warp interleaved pass by pass.  A
// value read from bf16 (B, C and x in a bf16 call) is exact in TF32 and
// takes no lo part.  So in a bf16 call G takes one pass; D = dy x^T, x dS'^T,
// B dS', (sum W) B, (sum W)^T C and the chunk sums C^T (e o dy) two (dy,
// dS', W, e o dy split); A^T dy and dy S^T three; in a float32 call every
// product three.  No product takes a single TF32 pass over a float32 value
// (tests/test_torch_ssd_bwd.py emulates each product's split).
//
// Layout.  Every tile in shared memory is row-major with its element (r, c)
// at column c ^ swz(r): for float32 tiles (row stride a multiple of 32
// words) 8 ((r & 3) ^ ((r >> 2) & 1)), for bf16 ones (a multiple of 64
// elements) 8 (r & 7).  An mma's k slots t and t + 4 hold k = 2t and 2t + 1
// in both operands, so a fragment read along a row takes both of a lane's
// values in one 8-byte (bf16: 4-byte) load, and a fragment read down the
// columns (an operand stored transposed: A^T, B^T, W^T) hits distinct banks
// too: each operand is read as it was stored, with no transposed copy and
// no bank conflict.  The swizzles move aligned groups of 8 elements whole,
// so the 16-byte copies stay 16-byte.  In the chunk scan warp w owns output
// rows 16 (w % 4) .. +15 of every product and, of those over L or P, a
// group of 32 / (N / 64) columns, of those over N a 32-column half of its
// half's slice: the causal (L, L) products skip the 8-column tiles above
// the diagonal, and A^T dy runs k from the warp's first row.
//
// Shared memory, registers and blocks an SM on an H100 (ptxas -v; PERF.md
// row 16).  The chunk scan keeps dy, A, S, dS' (at N 64 in A's tile), the
// group's W sum and G as float32 tiles, and B, C and x in the operands'
// dtype: bf16 at N 64 (Zamba2's training shape) 106.8 KB and 128
// registers, two blocks of 8 warps an SM; bf16 at N 128 (mamba2-130m's)
// 171.8 KB and 125 registers, one block of 16 warps (its two halves);
// float32 130.8 KB and 185 registers at N 64 (one block of 8 warps), 211.8
// KB and 122 at N 128 (16).  No instance spills.  The pass holds 73.3 KB
// (three stages of dy, 32 columns of C and the decays) and 93 (bf16) or 105
// registers, two blocks of 8 warps an SM.
//
// What bounds each kernel on an H100.  The chunk scan: its bytes (S, dS'
// and dy in float32, x, dx; 0.167 ms at Zamba2's 2 x 4096) beside the TF32
// products with each split pass counted (0.08 ms at 495 TFLOP/s); it runs
// at several times that, held by mma.sync's fragment loads and splits from
// shared memory (about four instructions an mma) and the per-head phases'
// barriers.  The pass: its bytes (dy read once, dS' written once; C and the
// decays), 0.08 ms at Zamba2's 268 MB.  The reduction: its bytes.

__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) { *p = __float2bfloat16_rn(v); }
// Two adjacent outputs (p 8-byte aligned for float, 4 for bf16).
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T>
__device__ __forceinline__ T zero_of() { return T(0.0f); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

// The swizzle of row r of a tile of T (above): float32 tiles (row stride a
// multiple of 32 words) XOR 8 f(r), f(r) = (r & 3) ^ ((r >> 2) & 1), which
// takes four distinct values on rows 0-3, on rows 4-7, on the even and on
// the odd rows of any eight; bf16 tiles (row stride a multiple of 64
// elements) XOR 8 (r & 7).  Both move aligned groups of 8 elements whole.
template <typename T>
__device__ __forceinline__ int swz(int r) {
  if constexpr (std::is_same<T, float>::value) return 8 * ((r & 3) ^ ((r >> 2) & 1));
  else return 8 * (r & 7);
}
// The offset of element (r, c) of a swizzled tile of T with row stride ld.
template <typename T>
__device__ __forceinline__ int sw(int r, int c, int ld) { return r * ld + (c ^ swz<T>(r)); }

// Two adjacent elements (8-byte aligned for float, 4 for bf16) as float.
__device__ __forceinline__ float2 ld_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// cvt.rna.tf32.f32 on a finite value: round the magnitude to 10 mantissa
// bits, ties away from zero, with two integer operations (adding half of
// the 13 dropped bits to the sign-magnitude encoding carries into the
// exponent exactly when the magnitude rounds up to it).  cvt.rna.tf32 itself
// costs about four times as many instructions on sm_90, which made the
// splits the bulk of the products' instructions.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// hi and lo TF32 parts of v; lo is 0 (and unused) when v is exact in TF32.
template <bool kSplit>
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  if constexpr (kSplit) {
    hi = tf32_rna(v);
    lo = tf32_rna(v - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(v);
    lo = 0u;
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A warp's product on the tensor cores: for mt < MT and nt < nt_end,
//   acc[mt][nt] += sum_{k < kn} Aop(m0 + 16 mt + ., ka0 + k) Bop(kb0 + k, n0 + 8 nt + .)
// in m16n8k8 accumulator layout.  Aop is stored by rows (A[r][k]) or, AK, by
// k (A[k][r]); Bop by its columns (B[n][k]) or, BK, by k (B[k][n]); all
// swizzled tiles.  SA / SB split that operand (a float32 value), else it is
// exact in TF32.  BS scales Bop's row k by bscale[kb0 + k].  An mma's k slot
// t holds k = 2 t of its 8 and slot t + 4 holds 2 t + 1, in A and in B alike
// (the sum over k is the same), so a fragment read along a row takes both
// of a lane's values in one 8-byte (bf16: 4-byte) load.  m0, n0, ka0, kb0
// and kn are multiples of 8 (kn of 16), so the swizzle of every element the
// lane reads depends on the lane alone: its offsets are worked out once,
// and a step of k adds a base (K * ld for a tile stored by k; K ^ swz for
// one stored by rows, K the step's first k).
template <int MT, int NT, bool AK, bool BK, bool SA, bool SB, bool BS = false, int UR = 2,
          typename TA, typename TB>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4], const TA* __restrict__ A,
                                         int lda, int m0, int ka0, const TB* __restrict__ B,
                                         int ldb, int n0, int kb0, int kn, int nt_end = NT,
                                         const float* __restrict__ bscale = nullptr) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int sa = swz<TA>(g);   // rows g and g + 8 of a tile stored by rows
  const int sb = swz<TB>(g);
  // A: by rows, (row g [+ 8], k 2t); by k, (k 2t + u, row g [+ 8]): [mt][h][u].
  int oa[MT][2][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = m0 + 16 * mt + 8 * hf + g;
        oa[mt][hf][u] = AK ? (2 * t + u) * lda + (r ^ swz<TA>(2 * t + u)) : r * lda + 2 * t;
      }
  // B: by columns, (column g, k 2t); by k, (k 2t + u, column g): [nt][u].
  int ob[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = n0 + 8 * nt + g;
      ob[nt][u] = BK ? (2 * t + u) * ldb + (c ^ swz<TB>(2 * t + u)) : c * ldb + 2 * t;
    }
#pragma unroll UR
  for (int k = 0; k < kn; k += 8) {
    const TA* Ak = A + (AK ? (ka0 + k) * lda : (ka0 + k) ^ sa);
    const TB* Bk = B + (BK ? (kb0 + k) * ldb : (kb0 + k) ^ sb);
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float v[4];   // a0 (g, 2t), a1 (g + 8, 2t), a2 (g, 2t + 1), a3 (g + 8, 2t + 1)
      if constexpr (AK) {
        v[0] = to_f(Ak[oa[mt][0][0]]);
        v[1] = to_f(Ak[oa[mt][1][0]]);
        v[2] = to_f(Ak[oa[mt][0][1]]);
        v[3] = to_f(Ak[oa[mt][1][1]]);
      } else {
        const float2 lo = ld_pair(Ak + oa[mt][0][0]);
        const float2 hi = ld_pair(Ak + oa[mt][1][0]);
        v[0] = lo.x;
        v[1] = hi.x;
        v[2] = lo.y;
        v[3] = hi.y;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) split<SA>(v[q], ah[mt][q], al[mt][q]);
    }
    float s0 = 1.0f, s1 = 1.0f;
    if constexpr (BS) {
      s0 = bscale[kb0 + k + 2 * t];
      s1 = bscale[kb0 + k + 2 * t + 1];
    }
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt < nt_end) {
        float b0, b1;
        if constexpr (BK) {
          b0 = to_f(Bk[ob[nt][0]]);
          b1 = to_f(Bk[ob[nt][1]]);
        } else {
          const float2 v = ld_pair(Bk + ob[nt][0]);
          b0 = v.x;
          b1 = v.y;
        }
        if constexpr (BS) {
          b0 *= s0;
          b1 *= s1;
        }
        split<SB>(b0, bh[nt][0], bl[nt][0]);
        split<SB>(b1, bh[nt][1], bl[nt][1]);
      }
    }
    // Each tile takes lo.hi, hi.lo, then hi.hi (the small terms first), the
    // tiles interleaved so that no mma waits on the one before it.
    if constexpr (SA) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          if (nt < nt_end) mma_tf32(acc[mt][nt], al[mt], bh[nt]);
    }
    if constexpr (SB) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          if (nt < nt_end) mma_tf32(acc[mt][nt], ah[mt], bl[nt]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        if (nt < nt_end) mma_tf32(acc[mt][nt], ah[mt], bh[nt]);
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&a)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) a[i][j][q] = 0.0f;
}

__device__ __forceinline__ float4 ld4g(const float* __restrict__ p) {
  return *reinterpret_cast<const float4*>(p);
}

// 16-byte cp.async into shared memory; nothing is read and zeros are written
// when !valid (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [t0, t0 + kL) of a (seq, W) operand (row stride ld elements, W
// contiguous) into the swizzled [kL][W] tile dst (kind T), zero past the
// chunk or the sequence: 16 loads a thread in flight, then their stores.
template <int W, int kBlock, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, long long ld, int t0,
                                          int chunk, int seq) {
  constexpr int kIter = kL * W / kBlock;
  constexpr int kBatch = kIter < 16 ? kIter : 16;
#pragma unroll
  for (int k0 = 0; k0 < kIter; k0 += kBatch) {
    T v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int e = threadIdx.x + (k0 + k) * kBlock;
      const int r = e / W;
      v[k] = (r < chunk && t0 + r < seq) ? src[(t0 + r) * ld + e % W] : zero_of<T>();
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int e = threadIdx.x + (k0 + k) * kBlock;
      dst[sw<T>(e / W, e % W, W)] = v[k];
    }
  }
}

// ---- the fused chunk sums and reverse state pass

constexpr int kPassThreads = 256;
constexpr int kPassRows = 32;   // state rows a block owns
constexpr int kPassStages = 3;  // sub-chunks in the ring
// A stage: dy [kL][kP] float32, C [kL][128 bytes] (32 columns in the
// operands' dtype), cum [kL]; bytes.
constexpr int kPassStageBytes = 4 * kL * kP + 128 * kL + 4 * kL;
constexpr size_t kPassSmem = kPassStages * kPassStageBytes + 2 * 4 * kL;

// Sub-chunk c's dy, C and decays into a stage by 16-byte cp.async (zeros
// past the chunk or the sequence).  C's rows are 16-byte aligned (the
// wrapper sees to it).
template <typename T>
__device__ __forceinline__ void pass_issue(unsigned char* st, const float* __restrict__ dy_bh,
                                           long long dy_t, const T* __restrict__ c_bs,
                                           long long c_t, const float* __restrict__ cum_c,
                                           int t0, int chunk, int seq) {
  float* sDy = reinterpret_cast<float*>(st);
  T* sC = reinterpret_cast<T*>(st + 4 * kL * kP);
  float* sCum = reinterpret_cast<float*>(st + 4 * kL * kP + 128 * kL);
#pragma unroll
  for (int k = 0; k < kL * kP / (4 * kPassThreads); ++k) {
    const int e = threadIdx.x + k * kPassThreads;
    const int r = e >> 4;
    const int col = (e & 15) * 4;
    const bool valid = r < chunk && t0 + r < seq;
    cp_async16(sDy + sw<float>(r, col, kP), valid ? dy_bh + (t0 + r) * dy_t + col : dy_bh,
               valid);
  }
  constexpr int kE = 16 / sizeof(T);            // elements a copy
  constexpr int kLd = 128 / sizeof(T);          // the C tile's row stride
  constexpr int kPerRow = kPassRows / kE;       // copies a row
#pragma unroll
  for (int k = 0; k < kL * kPerRow / kPassThreads; ++k) {
    const int e = threadIdx.x + k * kPassThreads;
    const int r = e / kPerRow;
    const int col = (e % kPerRow) * kE;
    const bool valid = r < chunk && t0 + r < seq;
    cp_async16(sC + sw<T>(r, col, kLd), valid ? c_bs + (t0 + r) * c_t + col : c_bs, valid);
  }
  if (threadIdx.x < kL / 4) cp_async16(sCum + threadIdx.x * 4, cum_c + threadIdx.x * 4, true);
}

// dS' of every sub-chunk for state rows r0 .. r0 + 31 of one (batch, head),
// the chunk sums C^T (e o dy) on the tensor cores.  Warp w owns rows
// 16 (w % 2) .. +15 and columns 16 (w / 2) .. +15 of the block's (32, P)
// (one m16 tile by two n8 tiles).  dy (B, T, H, P) and the decays are
// contiguous float32; C (B, T, N) strided with 16-byte aligned rows.
// Sub-chunk c's operands are copied two sub-chunks ahead, and the threads
// that copy its decays also take their exp once they land, so a step waits
// on no load and has one barrier.
template <typename T>
__global__ void __launch_bounds__(kPassThreads, 2)
    ssd_bwd_state_pass_kernel(const T* __restrict__ cm, const float* __restrict__ dy,
                              const float* __restrict__ cumbuf, const float* __restrict__ dfinal,
                              float* __restrict__ ds_out, long long c_b, long long c_t,
                              int nheads, int seq, int chunk, int n) {
  constexpr bool kExact = !std::is_same<T, float>::value;   // C read from bf16
  constexpr int kLd = 128 / sizeof(T);
  extern __shared__ __align__(16) unsigned char pbuf[];
  float* sE = reinterpret_cast<float*>(pbuf + kPassStages * kPassStageBytes);   // [2][kL]

  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int r0 = blockIdx.x * kPassRows;
  const int m0 = 16 * (w & 1);    // the warp's rows within the block's 32
  const int n0 = 16 * (w >> 1);   // its columns
  const int n_chunks = (seq + chunk - 1) / chunk;
  const long long dy_t = static_cast<long long>(nheads) * kP;
  const float* dy_bh = dy + static_cast<long long>(b) * seq * dy_t + h * kP;
  const T* c_bs = cm + b * c_b + r0;
  const long long np = static_cast<long long>(n) * kP;
  const float* cum_bh = cumbuf + (static_cast<long long>(b) * n_chunks * nheads + h) * kL;
  const long long cum_c = static_cast<long long>(nheads) * kL;   // a sub-chunk's stride

  // Fragment offsets (k slots t and t + 4 hold k = 2t and 2t + 1, as in
  // warp_mma): A = C^T from the C tile stored by k, B = dy stored by k.
  int oa[4];
  oa[0] = sw<T>(2 * t, m0 + g, kLd);
  oa[1] = sw<T>(2 * t, m0 + 8 + g, kLd);
  oa[2] = sw<T>(2 * t + 1, m0 + g, kLd);
  oa[3] = sw<T>(2 * t + 1, m0 + 8 + g, kLd);
  int ob[2][2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    ob[nt][0] = sw<float>(2 * t, n0 + 8 * nt + g, kP);
    ob[nt][1] = sw<float>(2 * t + 1, n0 + 8 * nt + g, kP);
  }

  // The carried gradient: rows r0 + m0 + g (+ 8), columns n0 + 8 nt + 2 t
  // (+ 1), from the final state's gradient.
  float gs[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = r0 + m0 + g + 8 * (q >> 1);
      const int col = n0 + 8 * nt + 2 * t + (q & 1);
      gs[nt][q] =
          dfinal != nullptr ? dfinal[(static_cast<long long>(b) * nheads + h) * np + row * kP + col]
                            : 0.0f;
    }

  const int last = n_chunks - 1;
  pass_issue<T>(pbuf, dy_bh, dy_t, c_bs, c_t, cum_bh + last * cum_c, last * chunk, chunk, seq);
  cp_async_commit();
  if (last >= 1)
    pass_issue<T>(pbuf + kPassStageBytes, dy_bh, dy_t, c_bs, c_t, cum_bh + (last - 1) * cum_c,
                  (last - 1) * chunk, chunk, seq);
  cp_async_commit();
  for (int s = 0; s <= last; ++s) {
    const int c = last - s;
    const unsigned char* st = pbuf + (s % kPassStages) * kPassStageBytes;
    const float* sDy = reinterpret_cast<const float*>(st);
    const T* sC = reinterpret_cast<const T*>(st + 4 * kL * kP);
    float* sEs = sE + (s & 1) * kL;
    cp_async_wait<1>();   // this thread's copies of stage s are in
    if (tid < kL / 4) {   // the threads that copied the decays take their exp
      const float4 v = *reinterpret_cast<const float4*>(st + 4 * kL * kP + 128 * kL + 16 * tid);
      *reinterpret_cast<float4*>(sEs + 4 * tid) =
          make_float4(expf(v.x), expf(v.y), expf(v.z), expf(v.w));
    }
    __syncthreads();   // stage s and its exps are in; every read of stage s - 1 is done
    if (c >= 2)
      pass_issue<T>(pbuf + ((s + 2) % kPassStages) * kPassStageBytes, dy_bh, dy_t, c_bs, c_t,
                    cum_bh + (c - 2) * cum_c, (c - 2) * chunk, chunk, seq);
    cp_async_commit();
    const float decay = sEs[kL - 1];
    float q[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) q[nt][i] = 0.0f;
#pragma unroll
    for (int k = 0; k < kL; k += 8) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split<!kExact>(to_f(sC[k * kLd + oa[i]]), ah[i], al[i]);
      const float s0 = sEs[k + 2 * t];
      const float s1 = sEs[k + 2 * t + 1];
      uint32_t bh[2][2], bl[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        split<true>(sDy[k * kP + ob[nt][0]] * s0, bh[nt][0], bl[nt][0]);
        split<true>(sDy[k * kP + ob[nt][1]] * s1, bh[nt][1], bl[nt][1]);
      }
      // lo.hi, hi.lo, hi.hi for each tile, the two tiles interleaved.
      if constexpr (!kExact) {
        mma_tf32(q[0], al, bh[0]);
        mma_tf32(q[1], al, bh[1]);
      }
      mma_tf32(q[0], ah, bl[0]);
      mma_tf32(q[1], ah, bl[1]);
      mma_tf32(q[0], ah, bh[0]);
      mma_tf32(q[1], ah, bh[1]);
    }
    float* out = ds_out + ((static_cast<long long>(b) * n_chunks + c) * nheads + h) * np;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = r0 + m0 + g + 8 * hf;
        const int col = n0 + 8 * nt + 2 * t;
        store2(out + row * kP + col, gs[nt][2 * hf], gs[nt][2 * hf + 1]);
        gs[nt][2 * hf] = gs[nt][2 * hf] * decay + q[nt][2 * hf];
        gs[nt][2 * hf + 1] = gs[nt][2 * hf + 1] * decay + q[nt][2 * hf + 1];
      }
  }
  cp_async_wait<0>();
}

// ---- the chunk scan

// Shared memory and shape of the chunk scan for operand type T and state
// size N: one 8-warp half a 64-column slice of N (two halves, one block
// of 16 warps, at N 128).
template <typename T, int N>
struct BwdScanSmem {
  static constexpr int kS = N / 64;             // slices of N, halves of the block
  static constexpr int kBlock = kThreads * kS;  // threads
  static constexpr int kWarps = kBlock / 32;
  // Float tiles dy, A (at N 64 then dS'), S (kS slices), dS' (kS slices,
  // at N 128 only), the W sum and G; cum, e, w; the row and z (2 kS x kL,
  // by 4-warp column group) and column (4 x kL, by row tile) partials of
  // dcum; <S, dS'> by warp; then B, C and x in the operands' dtype.
  static constexpr int kFloats = (4 + kS + (kS > 1 ? kS : 0)) * kL * kP + 3 * kL +
                                 4 * kS * kL + 4 * kL + kWarps;
  static constexpr size_t bytes = sizeof(float) * kFloats + sizeof(T) * (2 * kL * N + kL * kP);
  static constexpr int blocks = kS == 1 && bytes <= 113 * 1024 ? 2 : 1;
};

// Rows [0, rows) of a (., kP) tile of T whose row r is src + r * ld (rows
// 16-byte aligned) into the swizzled tile dst by 16-byte cp.async, zeros in
// rows [rows, R); kBlock threads.
template <int R, int kBlock, typename T>
__device__ __forceinline__ void copy_tile(T* dst, const T* __restrict__ src, long long ld,
                                          int rows) {
  constexpr int kE = 16 / sizeof(T);   // elements a copy
  constexpr int kPerRow = kP / kE;
#pragma unroll 1   // one address at a time: the copies are issued between products
  for (int k = 0; k < R * kPerRow / kBlock; ++k) {
    const int e = threadIdx.x + k * kBlock;
    const int r = e / kPerRow;
    const int col = (e % kPerRow) * kE;
    cp_async16(dst + sw<T>(r, col, kP), r < rows ? src + r * ld + col : src, r < rows);
  }
}

// dx and d log_a of every head of the group, and the group's dB and dC.
// Warp w (of 8 kS) owns rows 16 (w % 4) .. +15 of every product: of the
// ones that do not run over N (G, D, A^T dy, B dS') the 32 / kS columns
// from (w / 4) 32 / kS; of the ones that do (dy S^T, x dS'^T, the W terms,
// dB and dC) the 32-column half (w / 4) % 2 of slice w / 8.  Each head's
// x, dy, decays and S, and its dS', arrive by cp.async one phase ahead of
// their use: the next head's x, dy, decays and S during this head's dS'
// products; dS' at N 64 during dy S^T (into A's tile, free by then), at N
// 128 during D and A^T dy (its own tiles).
template <typename T, int N>
__global__ void __launch_bounds__(BwdScanSmem<T, N>::kBlock, (BwdScanSmem<T, N>::blocks))
    ssd_bwd_chunk_scan_kernel(const T* __restrict__ bm, const T* __restrict__ cm,
                              const T* __restrict__ x, const float* __restrict__ dy,
                              const float* __restrict__ s_in, const float* __restrict__ ds_out,
                              const float* __restrict__ cumbuf, float* __restrict__ dla,
                              T* __restrict__ dx, float* __restrict__ part, const Strides st,
                              int nheads, int seq, int chunk, int group) {
  using Smem = BwdScanSmem<T, N>;
  constexpr bool kExact = !std::is_same<T, float>::value;   // B, C, x read from bf16
  constexpr int kS = Smem::kS;
  constexpr int kBlock = Smem::kBlock;
  constexpr int kWarps = Smem::kWarps;
  constexpr int kNG = 4 / kS;                               // 8-column tiles a column group
  extern __shared__ __align__(16) float smem[];
  float* sDy = smem;                   // [kL][kP]       dy_i
  float* sA = sDy + kL * kP;           // [kL][kL]       A = M o G (N 64: then dS')
  float* sSt = sA + kL * kL;           // [N][kP]        S
  float* sD = kS > 1 ? sSt + N * kP : sA;   // [N][kP]   dS'
  float* sWs = sSt + (kS > 1 ? 2 : 1) * N * kP;   // [kL][kL]  sum over the group of W = M o D
  float* sG = sWs + kL * kL;           // [kL][kL]       C_i . B_j
  float* sCum = sG + kL * kL;          // [kL]
  float* sE = sCum + kL;               // [kL]  exp(cum_i)
  float* sWv = sE + kL;                // [kL]  exp(cum_last - cum_j)
  float* sRow = sWv + kL;              // [2 kS][kL]  row terms of dcum, by column group
  float* sZ = sRow + 2 * kS * kL;      // [2 kS][kL]  x . dx_inter, by column group
  float* sCol = sZ + 2 * kS * kL;      // [4][kL]     column sums of A o D, by row tile
  float* sDot = sCol + 4 * kL;         // [warps]     <S, dS'>
  T* sB = reinterpret_cast<T*>(sDot + kWarps);   // [kL][N]  B_j
  T* sC = sB + kL * N;                 // [kL][N]  C_i
  T* sX = sC + kL * N;                 // [kL][kP] x_j

  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = 16 * (w & 3);         // the warp's output rows
  const int wq = w >> 2;               // its column group
  const int cg = wq * (32 / kS);       // the group's first column of an (L, L) or (L, P) product
  const int hs = w >> 3;               // its slice of N
  const int cs = kL * hs + 32 * (wq & 1);   // its first column of N in the slice products
  const int c = blockIdx.x;
  const int b = blockIdx.z;
  const int h0 = blockIdx.y * group;
  const int h1 = min(h0 + group, nheads);
  const int t0 = c * chunk;
  const int n_chunks = gridDim.x;
  const int valid = min(chunk, seq - t0);   // rows of the sub-chunk in the sequence
  const long long dy_t = static_cast<long long>(nheads) * kP;
  // The 8-column tiles of this warp's group on or below the diagonal.
  const int nt_causal = max(0, min(kNG, (m0 >> 3) + 2 - (cg >> 3)));
  const float* dy_b = dy + (static_cast<long long>(b) * seq + t0) * dy_t;
  const T* x_b = x + b * st.x_b + t0 * st.x_t;
  auto bch_of = [&](int h) { return (static_cast<long long>(b) * n_chunks + c) * nheads + h; };

  // The first head's x, dy, decays and S.
  copy_tile<kL, kBlock>(sX, x_b + h0 * st.x_h, st.x_t, valid);
  copy_tile<kL, kBlock>(sDy, dy_b + h0 * kP, dy_t, valid);
  if (tid < kL / 4) cp_async16(sCum + 4 * tid, cumbuf + bch_of(h0) * kL + 4 * tid, true);
  copy_tile<N, kBlock>(sSt, s_in + bch_of(h0) * N * kP, kP, N);
  cp_async_commit();
  load_tile<N, kBlock>(sB, bm + b * st.b_b, st.b_t, t0, chunk, seq);
  load_tile<N, kBlock>(sC, cm + b * st.c_b, st.c_t, t0, chunk, seq);
#pragma unroll
  for (int k = 0; k < kL * kL / (4 * kBlock); ++k)
    reinterpret_cast<float4*>(sWs)[tid + k * kBlock] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
  {
    float gacc[1][kNG][4];   // G on the warp's causal tiles (rows i, columns j)
    zero(gacc);
    if (nt_causal > 0)
      warp_mma<1, kNG, false, false, !kExact, !kExact>(gacc, sC, N, m0, 0, sB, N, cg, 0, N,
                                                       nt_causal);
    int grow = m0 + g;
    asm volatile("" : "+r"(grow));   // the D epilogue works its own offsets out: none held
#pragma unroll
    for (int nt = 0; nt < kNG; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        store2(sG + sw<float>(grow + 8 * hf, cg + 8 * nt + 2 * t, kL), gacc[0][nt][2 * hf],
               gacc[0][nt][2 * hf + 1]);
  }
  float dBacc[1][4][4];   // the group's dB and dC on this warp's tiles of its slice
  float dCacc[1][4][4];
  zero(dBacc);
  zero(dCacc);

  for (int h = h0; h < h1; ++h) {
    const long long bch = bch_of(h);
    cp_async_wait<0>();
    __syncthreads();   // x, dy, the decays and S are in; G is in
    if constexpr (kS > 1) {   // this head's dS', during D and A^T dy
      copy_tile<N, kBlock>(sD, ds_out + bch * N * kP, kP, N);
      cp_async_commit();
    }
    if (tid < kL) {
      const float cum = sCum[tid];
      sE[tid] = expf(cum);
      sWv[tid] = expf(sCum[kL - 1] - cum);
    }
    float rowp[2] = {0.0f, 0.0f};   // rows m0 + g, m0 + g + 8: this thread's share of dcum
    float zp[2] = {0.0f, 0.0f};
    {
      // D = dy x^T on the causal tiles; the mask before the exp; A stored,
      // W summed over the group, A o D summed by row and by column.
      float d[1][kNG][4];
      zero(d);
      if (nt_causal > 0)
        warp_mma<1, kNG, false, false, true, !kExact>(d, sDy, kP, m0, 0, sX, kP, cg, 0, kP,
                                                      nt_causal);
#pragma unroll
      for (int nt = 0; nt < kNG; ++nt) {
        float colp[2] = {0.0f, 0.0f};
        if (nt < nt_causal) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = m0 + g + 8 * hf;
            const int col = cg + 8 * nt + 2 * t;
            const int off = sw<float>(row, col, kL);   // (row, col) and (row, col + 1)
            const float2 gv = ld_pair(sG + off);
            float2 wsum = ld_pair(sWs + off);
            const float ci = sCum[row];
            float a2[2];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const bool causal = col + q <= row;
              const float diff = causal ? ci - sCum[col + q] : 0.0f;
              const float m = causal ? expf(diff) : 0.0f;
              const float a = m * (q ? gv.y : gv.x);
              const float dv = d[0][nt][2 * hf + q];
              a2[q] = a;
              if (causal) (q ? wsum.y : wsum.x) += m * dv;
              const float v = a * dv;
              rowp[hf] += v;
              colp[q] += v;
            }
            store2(sA + off, a2[0], a2[1]);
            store2(sWs + off, wsum.x, wsum.y);
          }
        }
        // This tile's column sums over the warp's 16 rows (lanes of one t),
        // in a fixed order.
#pragma unroll
        for (int q = 0; q < 2; ++q) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            colp[q] += __shfl_xor_sync(0xffffffffu, colp[q], off);
          if (g == 0) sCol[(m0 >> 4) * kL + cg + 8 * nt + 2 * t + q] = colp[q];
        }
      }
    }
    __syncthreads();   // A, the W sum, e and w are in
    // dx = A^T dy (i >= j), then + w o (B dS').
    float dxa[1][kNG][4];
    zero(dxa);
    warp_mma<1, kNG, true, true, true, true>(dxa, sA, kL, m0, m0, sDy, kP, cg, m0, kL - m0);
    if constexpr (kS == 1) {   // dS' into A's tile, during dy S^T
      __syncthreads();         // the reads of A are done
      copy_tile<kL, kBlock>(sD, ds_out + bch * N * kP, kP, kL);
      cp_async_commit();
    }
    float tmp[1][4][4];
    // dC_inter = e o (dy S^T) over this warp's slice; dC += it; its dcum term C_i . dC_inter_i.
    zero(tmp);
    warp_mma<1, 4, false, false, true, true>(tmp, sDy, kP, m0, 0, sSt + hs * kL * kP, kP,
                                             32 * (wq & 1), 0, kP);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = m0 + g + 8 * (q >> 1);
        const int col = cs + 8 * nt + 2 * t + (q & 1);
        const float v = tmp[0][nt][q] * sE[row];
        dCacc[0][nt][q] += v;
        rowp[q >> 1] += to_f(sC[sw<T>(row, col, N)]) * v;
      }
    cp_async_wait<0>();
    __syncthreads();   // dS' is in; the reads of dy are done
    float dot = 0.0f;
    {
      // <S, dS'> over this thread's share of its half's slice.
      const float* s_h = sSt + hs * kL * kP;
      const float* d_h = sD + hs * kL * kP;
#pragma unroll
      for (int k = 0; k < kL * kP / (4 * kThreads); ++k) {
        const int e = (tid & (kThreads - 1)) + k * kThreads;
        const int off = sw<float>(e >> 4, (e & 15) * 4, kP);
        const float4 sv = *reinterpret_cast<const float4*>(s_h + off);
        const float4 dv = *reinterpret_cast<const float4*>(d_h + off);
        dot += sv.x * dv.x + sv.y * dv.y + sv.z * dv.z + sv.w * dv.w;
      }
    }
    __syncthreads();   // the reads of S are done
    if (h + 1 < h1) {   // the next head's dy, decays and S
      copy_tile<kL, kBlock>(sDy, dy_b + (h + 1) * kP, dy_t, valid);
      if (tid < kL / 4) cp_async16(sCum + 4 * tid, cumbuf + bch_of(h + 1) * kL + 4 * tid, true);
      copy_tile<N, kBlock>(sSt, s_in + bch_of(h + 1) * N * kP, kP, N);
      cp_async_commit();
    }
    // x dS'^T over this warp's slice: dB += w o it; x . dx_inter = w_j B_j . (x dS'^T)_j.
    zero(tmp);
    warp_mma<1, 4, false, false, !kExact, true>(tmp, sX, kP, m0, 0, sD + hs * kL * kP, kP,
                                                32 * (wq & 1), 0, kP);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = m0 + g + 8 * (q >> 1);
        const int col = cs + 8 * nt + 2 * t + (q & 1);
        const float v = tmp[0][nt][q];
        zp[q >> 1] += to_f(sB[sw<T>(row, col, N)]) * v;
        dBacc[0][nt][q] += v * sWv[row];
      }
    if (h + 1 < h1) {
      __syncthreads();   // the reads of x are done
      copy_tile<kL, kBlock>(sX, x_b + (h + 1) * st.x_h, st.x_t, valid);
      cp_async_commit();
    }
    // B dS' over every slice's k: dx += w o it.
    {
      float bd[1][kNG][4];
      zero(bd);
#pragma unroll
      for (int s = 0; s < kS; ++s)
        warp_mma<1, kNG, false, true, !kExact, true>(bd, sB, N, m0, kL * s, sD + s * kL * kP,
                                                     kP, cg, 0, kL);
#pragma unroll
      for (int nt = 0; nt < kNG; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) dxa[0][nt][q] += bd[0][nt][q] * sWv[m0 + g + 8 * (q >> 1)];
    }
    // dx, the rows in the sequence.
#pragma unroll
    for (int nt = 0; nt < kNG; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = m0 + g + 8 * hf;
        if (j < valid)
          store2(dx + ((static_cast<long long>(b) * seq + t0 + j) * nheads + h) * kP + cg +
                     8 * nt + 2 * t,
                 dxa[0][nt][2 * hf], dxa[0][nt][2 * hf + 1]);
      }
    // The row terms over the quad, in a fixed order.
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        rowp[hf] += __shfl_xor_sync(0xffffffffu, rowp[hf], off);
        zp[hf] += __shfl_xor_sync(0xffffffffu, zp[hf], off);
      }
    }
    if (t == 0) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        sRow[wq * kL + m0 + g + 8 * hf] = rowp[hf];
        sZ[wq * kL + m0 + g + 8 * hf] = zp[hf] * sWv[m0 + g + 8 * hf];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (lane == 0) sDot[w] = dot;
    __syncthreads();
    if (tid < 32) {
      // dcum of rows 2 lane and 2 lane + 1, the last step's terms, then
      // d log_a as the reverse inclusive sum (over lanes from the top).
      float dcv[2];
      float zsum = 0.0f;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int r = 2 * lane + k;
        float rs = 0.0f, zs = 0.0f;
#pragma unroll
        for (int u = 0; u < 2 * kS; ++u) {
          rs += sRow[u * kL + r];
          zs += sZ[u * kL + r];
        }
        const float cs4 = sCol[r] + sCol[kL + r] + sCol[2 * kL + r] + sCol[3 * kL + r];
        dcv[k] = rs - cs4 - zs;
        zsum += zs;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) zsum += __shfl_xor_sync(0xffffffffu, zsum, off);
      float sdot = 0.0f;
#pragma unroll
      for (int u = 0; u < kWarps; ++u) sdot += sDot[u];
      if (lane == 31) dcv[1] += sE[kL - 1] * sdot + zsum;   // exp(cum_last) <S, dS'>
      float suf = dcv[0] + dcv[1];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_down_sync(0xffffffffu, suf, off);
        if (lane + off < 32) suf += up;
      }
      float above = __shfl_down_sync(0xffffffffu, suf, 1);
      if (lane == 31) above = 0.0f;
      const float d1 = dcv[1] + above;
      const float d0 = dcv[0] + d1;
      float* out = dla + (static_cast<long long>(b) * seq + t0) * nheads + h;
      if (2 * lane < valid) out[static_cast<long long>(2 * lane) * nheads] = d0;
      if (2 * lane + 1 < valid) out[static_cast<long long>(2 * lane + 1) * nheads] = d1;
    }
  }
  __syncthreads();   // the group's W sum is in
  // The W terms once for the group over this warp's slice: dC += (sum W) B
  // (j <= i), dB += (sum W)^T C (i >= j).
  warp_mma<1, 4, false, true, true, !kExact>(dCacc, sWs, kL, m0, 0, sB, N, cs, 0, m0 + 16);
  warp_mma<1, 4, true, true, true, !kExact>(dBacc, sWs, kL, m0, m0, sC, N, cs, m0, kL - m0);
  // The group's dB and dC: part[which][b][c][group][row][n].
  const long long plane = static_cast<long long>(gridDim.z) * n_chunks * gridDim.y * kL * N;
  float* pb = part + ((static_cast<long long>(b) * n_chunks + c) * gridDim.y + blockIdx.y) * kL * N;
  int row0 = m0 + g;
  asm volatile("" : "+r"(row0));   // worked out here, not held (or spilled) across the head loop
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int idx = (row0 + 8 * hf) * N + cs + 8 * nt + 2 * t;
      store2(pb + idx, dBacc[0][nt][2 * hf], dBacc[0][nt][2 * hf + 1]);
      store2(pb + plane + idx, dCacc[0][nt][2 * hf], dCacc[0][nt][2 * hf + 1]);
    }
}

// dB and dC (B, T, N) in the operands' dtype: each element the sum of the
// head groups' partials in group order.  blockIdx.y: 0 dB, 1 dC.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_reduce_kernel(const float* __restrict__ part, T* __restrict__ db,
                          T* __restrict__ dc, int batch, int seq, int n, int chunk,
                          int n_chunks, int n_groups, long long total) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= total) return;
  const int which = blockIdx.y;
  const int nn = static_cast<int>(e % n);
  const long long bt = e / n;
  const int t = static_cast<int>(bt % seq);
  const long long b = bt / seq;
  const int c = t / chunk;
  const int r = t % chunk;
  const long long gs = static_cast<long long>(kL) * n;
  const float* src =
      part + (((which * batch + b) * n_chunks + c) * n_groups * kL + r) * n + nn;
  float s = 0.0f;
  for (int g = 0; g < n_groups; ++g) s += src[g * gs];
  from_f(s, (which ? dc : db) + e);
}

// Launchers, one a kernel, by operand type T and state size N.
struct BwdPass {
  template <typename T, int N>
  static cudaError_t run(const void* cm, const float* dy, const float* cumbuf,
                         const float* dfinal, float* ds_out, long long c_b, long long c_t,
                         int batch, int nheads, int seq, int chunk, cudaStream_t stream) {
    auto k = ssd_bwd_state_pass_kernel<T>;
    cudaError_t err =
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kPassSmem);
    if (err != cudaSuccess) return err;
    const dim3 grid(N / kPassRows, nheads, batch);
    k<<<grid, kPassThreads, kPassSmem, stream>>>(static_cast<const T*>(cm), dy, cumbuf, dfinal,
                                                 ds_out, c_b, c_t, nheads, seq, chunk, N);
    return cudaGetLastError();
  }
};

struct BwdScan {
  template <typename T, int N>
  static cudaError_t run(const void* bm, const void* cm, const void* x, const float* dy,
                         const float* s_in, const float* ds_out, const float* cumbuf,
                         float* dla, void* dx, float* part, const Strides st, int batch,
                         int nheads, int seq, int chunk, int group, cudaStream_t stream) {
    auto k = ssd_bwd_chunk_scan_kernel<T, N>;
    constexpr size_t bytes = BwdScanSmem<T, N>::bytes;
    cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((seq + chunk - 1) / chunk, (nheads + group - 1) / group, batch);
    k<<<grid, BwdScanSmem<T, N>::kBlock, bytes, stream>>>(
        static_cast<const T*>(bm), static_cast<const T*>(cm), static_cast<const T*>(x), dy, s_in,
        ds_out, cumbuf, dla, static_cast<T*>(dx), part, st, nheads, seq, chunk, group);
    return cudaGetLastError();
  }
};

template <typename Launch, typename... A>
cudaError_t by_type(int is_bf16, int n, A... a) {
  switch (n) {
    case 64:
      return is_bf16 ? Launch::template run<__nv_bfloat16, 64>(a...)
                     : Launch::template run<float, 64>(a...);
    case 128:
      return is_bf16 ? Launch::template run<__nv_bfloat16, 128>(a...)
                     : Launch::template run<float, 128>(a...);
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

// The backward's plain C entry points, one a kernel, loaded with ctypes.
// Each launches on `stream` of `device`, does not synchronise, and returns
// the first cudaError_t.  The wrapper (kernels/ssd/ops.py::bwd_launches)
// checks the operands: B, C and x as for ssd_scan_fwd (given by their
// element strides); dy (B, T, H, P) and dfinal (B, H, N, P; null: zeros)
// contiguous float32; s_in and cumbuf the forward's dS and decays'
// scratch; ds_out (B, n_chunks, H, N, P), part (2, B, n_chunks, groups, 64,
// N), d log_a (B, T, H) float32, dx (B, T, H, P), dB and dC (B, T, N) in the
// operands' dtype, all contiguous.  n, chunk and group as ssd_scan_fwd.
// The state pass copies C, the chunk scan x, by 16 bytes: their pointers
// and their strides but the last, in bytes, must be multiples of 16.

extern "C" int ssd_bwd_state_pass(const void* cm, const float* dy, const float* cumbuf,
                                  const float* dfinal, float* ds_out, long long c_b,
                                  long long c_t, int batch, int nheads, int seq, int n,
                                  int chunk, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (chunk < 1 || chunk > kL) return static_cast<int>(cudaErrorInvalidValue);
  const long long esize = is_bf16 ? 2 : 4;
  if (reinterpret_cast<uintptr_t>(cm) % 16 != 0 || (c_b * esize) % 16 != 0 ||
      (c_t * esize) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  return static_cast<int>(by_type<BwdPass>(is_bf16, n, cm, dy, cumbuf, dfinal, ds_out, c_b, c_t,
                                           batch, nheads, seq, chunk,
                                           static_cast<cudaStream_t>(stream)));
}

extern "C" int ssd_bwd_chunk_scan(const void* bm, const void* cm, const void* x, const float* dy,
                                  const float* s_in, const float* ds_out, const float* cumbuf,
                                  float* dla, void* dx, float* part, long long b_b,
                                  long long b_t, long long c_b, long long c_t, long long x_b,
                                  long long x_t, long long x_h, int batch, int nheads, int seq,
                                  int n, int chunk, int group, int is_bf16, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (chunk < 1 || chunk > kL || group < 1 || group > kMaxGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long esize = is_bf16 ? 2 : 4;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || (x_b * esize) % 16 != 0 ||
      (x_t * esize) % 16 != 0 || (x_h * esize) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Strides st{0, 0, b_b, b_t, c_b, c_t, x_b, x_t, x_h};
  return static_cast<int>(by_type<BwdScan>(is_bf16, n, bm, cm, x, dy, s_in, ds_out, cumbuf, dla,
                                           dx, part, st, batch, nheads, seq, chunk, group,
                                           static_cast<cudaStream_t>(stream)));
}

extern "C" int ssd_bwd_reduce(const float* part, void* db, void* dc, int batch, int seq, int n,
                              int chunk, int n_groups, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (chunk < 1 || chunk > kL || n_groups < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = (seq + chunk - 1) / chunk;
  const long long total = static_cast<long long>(batch) * seq * n;
  const dim3 grid(static_cast<unsigned>((total + kThreads - 1) / kThreads), 2);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    ssd_bwd_reduce_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        part, static_cast<__nv_bfloat16*>(db), static_cast<__nv_bfloat16*>(dc), batch, seq, n,
        chunk, n_chunks, n_groups, total);
  else
    ssd_bwd_reduce_kernel<float><<<grid, kThreads, 0, s>>>(
        part, static_cast<float*>(db), static_cast<float*>(dc), batch, seq, n, chunk, n_chunks,
        n_groups, total);
  return static_cast<int>(cudaGetLastError());
}
