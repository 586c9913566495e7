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


// ------------------------------------------------------------------ backward
//
// The gradient of the scan above.  The JAX package has no kernel for it (it
// differentiates models/ssm.py::_ssd_chunked in XLA), so these replace no TPU
// kernel.  Per sub-chunk and head, with dy the gradient of y, dS' that of the
// state leaving the sub-chunk, S the state entering it (the forward's dS
// scratch after its pass), G = C B^T, D_ij = dy_i . x_j,
// M_ij = exp(cum_i - cum_j) for j <= i (masked before the exp), A = M o G,
// W = M o D and w_j = exp(cum_last - cum_j):
//   dS    = exp(cum_last) dS' + sum_i exp(cum_i) C_i dy_i^T   (a reverse pass)
//   dx    = A^T dy + w o (B dS')
//   dC    = sum_h [W B + exp(cum) o (dy S^T)]        (B and C are shared
//   dB    = sum_h [W^T C + w o (x dS'^T)]             across heads)
//   dcum  = rowsum(A o D) - colsum(A o D) + C . dC_inter - x . dx_inter, and
//           exp(cum_last) <S, dS'> + sum_j x_j . dx_inter_j at the last step;
//   d log_a is the reverse cumulative sum of dcum within the sub-chunk.
//
//   ssd_bwd_chunk_dstate_kernel, one block per (sub-chunk, group of heads,
//     batch): each head's sum_i exp(cum_i) C_i dy_i^T into a float32 scratch
//     (B, n_chunks, H, N, P), as ssd_chunk_state_kernel builds dS.
//   ssd_bwd_state_pass_kernel, one thread an (N, P) entry of one (batch,
//     head): walks the chunks last to first from the final state's gradient
//     (0 for none), overwrites each chunk's sum with dS' and carries
//     g <- exp(cum_last) g + sum.
//   ssd_bwd_chunk_scan_kernel, one block per (sub-chunk, group of heads,
//     batch): G once, then per head D, A and W (shared memory), dx and
//     d log_a written, and dB and dC summed over the block's heads in
//     registers and written once as the block's partial (2, B, n_chunks,
//     groups, 64, N).
//   ssd_bwd_reduce_kernel, one thread an element of dB or dC: the groups'
//     partials added in group order, written in the operands' dtype.
// No atomics: two runs give the same bits.  The forward's decays (cum) and
// chunk states are read from its scratch, which the wrapper keeps under
// grad; nothing of the forward is recomputed.
//
// What bounds it on an H100: float32 operations on the CUDA cores.  Per
// (head, sub-chunk) D, A^T dy, W B and W^T C (2 L^2 P + 2 L^2 P + 4 L^2 N,
// about half of it under the causal mask) and the three state products
// B dS', dy S^T and x dS'^T (6 L N P), plus the chunk sums (2 L N P); per
// (batch, sub-chunk) group G (2 L^2 N).  Bytes: the two (B, n_chunks, H, N,
// P) float32 scratches read (S, and dS' written then read twice), the
// operands, dy and the outputs.  The chunk-scan block holds B, C, G, x, dy,
// A, W and one state in shared memory (198 KB at N 128, 148 KB at N 64: one
// block an SM); each thread owns rows ty*4 .. ty*4+3 and columns tx + 16 q
// of every product (tile_mm), reading each operand as stored, with rows
// padded to 16-byte multiples that put consecutive columns in other banks.

__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) { *p = __float2bfloat16_rn(v); }

constexpr int kRP = kL + 1;   // row stride of the (16, kL) partial-sum tiles

template <int R, int C>
__device__ __forceinline__ void zero(float (&a)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) a[i][j] = 0.0f;
}

// acc[i][q] += sum_{k0 <= k < k1} L(ty*4 + i, k) R(k, tx + 16 q), k0 and k1
// multiples of 4, in k order.  LK: L stored k-major (L[k * lds + row]), else
// by row (L[row * lds + k]); RK: R stored k-major (R[k * rds + col]), else by
// column (R[col * rds + k], rds = 4 mod 32 so that a quarter warp's 16-byte
// loads fall in distinct banks).  Every load is 16 bytes but RK's, a scalar
// a lane over consecutive columns.
template <int Q, bool LK, bool RK>
__device__ __forceinline__ void tile_mm(float (&acc)[4][Q], const float* __restrict__ L,
                                        int lds, const float* __restrict__ R, int rds, int k0,
                                        int k1) {
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
#pragma unroll 2
  for (int k = k0; k < k1; k += 4) {
    float lv[4][4];   // [row][k]
    float rv[Q][4];   // [column][k]
    if constexpr (LK) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 v = ld4(L + (k + kk) * lds + ty * 4);
        lv[0][kk] = v.x;
        lv[1][kk] = v.y;
        lv[2][kk] = v.z;
        lv[3][kk] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = ld4(L + (ty * 4 + i) * lds + k);
        lv[i][0] = v.x;
        lv[i][1] = v.y;
        lv[i][2] = v.z;
        lv[i][3] = v.w;
      }
    }
    if constexpr (RK) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < Q; ++q) rv[q][kk] = R[(k + kk) * rds + tx + 16 * q];
    } else {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float4 v = ld4(R + (tx + 16 * q) * rds + k);
        rv[q][0] = v.x;
        rv[q][1] = v.y;
        rv[q][2] = v.z;
        rv[q][3] = v.w;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < Q; ++q) acc[i][q] = __fmaf_rn(lv[i][kk], rv[q][kk], acc[i][q]);
  }
}

template <int N>
constexpr size_t bwd_dstate_smem_bytes() {
  // sC [kL][N+4]; sDy [kL][kP]; sW [kL].
  return sizeof(float) * (kL * (N + 4) + kL * kP + kL);
}

// Each head's sum_i exp(cum_i) C_i dy_i^T (N, P) into qbuf; dy (B, T, H, P)
// contiguous float32.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_bwd_chunk_dstate_kernel(const T* __restrict__ cm, const float* __restrict__ dy,
                                const float* __restrict__ cumbuf, float* __restrict__ qbuf,
                                long long c_b, long long c_t, int nheads, int seq, int chunk,
                                int group) {
  constexpr int CS = N + 4;   // row stride of C (16-byte rows)
  constexpr int NR = N / 16;  // state rows a thread owns
  extern __shared__ float smem[];
  float* sC = smem;            // [kL][CS]
  float* sDy = sC + kL * CS;   // [kL][kP]
  float* sW = sDy + kL * kP;   // [kL]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int c = blockIdx.x;
  const int b = blockIdx.z;
  const int h0 = blockIdx.y * group;
  const int h1 = min(h0 + group, nheads);
  const int t0 = c * chunk;
  const int n_chunks = gridDim.x;
  const long long dy_t = static_cast<long long>(nheads) * kP;
  {
    Rows<N, T> rc;
    rc.load(cm + b * c_b, c_t, t0, chunk, seq);
    rc.template store<CS>(sC);
  }
  for (int h = h0; h < h1; ++h) {
    const long long bch = (static_cast<long long>(b) * n_chunks + c) * nheads + h;
    __syncthreads();   // C is in; the previous head's reads are done
    {
      Rows<kP, float> rd;
      rd.load(dy + static_cast<long long>(b) * seq * dy_t + h * kP, dy_t, t0, chunk, seq);
      rd.template store<kP>(sDy);
    }
    if (tid < kL) sW[tid] = expf(cumbuf[bch * kL + tid]);
    __syncthreads();
    float acc[NR][4];
    zero(acc);
#pragma unroll 2
    for (int i = 0; i < kL; ++i) {
      const float wi = sW[i];
      const float4 dv = ld4(sDy + i * kP + tx * 4);
      const float dw[4] = {dv.x * wi, dv.y * wi, dv.z * wi, dv.w * wi};
      float cr[NR];
#pragma unroll
      for (int r = 0; r < NR; r += 4) {
        const float4 cv = ld4(sC + i * CS + ty * NR + r);
        cr[r] = cv.x;
        cr[r + 1] = cv.y;
        cr[r + 2] = cv.z;
        cr[r + 3] = cv.w;
      }
#pragma unroll
      for (int r = 0; r < NR; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = __fmaf_rn(cr[r], dw[q], acc[r][q]);
    }
    float* qs = qbuf + bch * N * kP;
#pragma unroll
    for (int r = 0; r < NR; ++r)
      *reinterpret_cast<float4*>(qs + (ty * NR + r) * kP + tx * 4) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

// The reverse state pass, one thread an entry of the (N, P) state of one
// (batch, head): from the final state's gradient (dfinal, or 0 when null),
// walks the chunks last to first, replaces each chunk's sum in qbuf by the
// gradient dS' of the state leaving that chunk and carries
// g <- exp(cum_last) g + sum.
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_state_pass_kernel(float* __restrict__ qbuf, const float* __restrict__ cumbuf,
                              const float* __restrict__ dfinal, int nheads, int np,
                              int n_chunks, long long total) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= total) return;
  const long long bh = e / np;
  const long long off = e % np;
  const long long b = bh / nheads;
  const long long h = bh % nheads;
  constexpr int kBatch = 8;   // chunks whose loads are in flight together
  float g = dfinal != nullptr ? dfinal[e] : 0.0f;
  for (int c1 = n_chunks - 1; c1 >= 0; c1 -= kBatch) {
    float q[kBatch];
    float cum_last[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const long long bch = (b * n_chunks + c1 - k) * nheads + h;
      const bool in = c1 - k >= 0;
      q[k] = in ? qbuf[bch * np + off] : 0.0f;
      cum_last[k] = in ? cumbuf[bch * kL + kL - 1] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c1 - k >= 0) {
        qbuf[((b * n_chunks + c1 - k) * nheads + h) * np + off] = g;
        g = g * expf(cum_last[k]) + q[k];
      }
    }
  }
}

// A (N, kP) float32 state into shared rows of kTS floats.
template <int N>
__device__ __forceinline__ void load_state(float* dst, const float* __restrict__ src) {
  constexpr int kIter = N * kP / (kThreads * 4);
  float4 v[kIter];
#pragma unroll
  for (int k = 0; k < kIter; ++k) v[k] = ld4(src + (threadIdx.x + k * kThreads) * 4);
#pragma unroll
  for (int k = 0; k < kIter; ++k) {
    const int e = (threadIdx.x + k * kThreads) * 4;
    *reinterpret_cast<float4*>(dst + (e / kP) * kTS + e % kP) = v[k];
  }
}

template <int N>
constexpr size_t bwd_scan_smem_bytes() {
  // sB, sC [kL][N+4]; sG, sX, sDy, sA, sW [kL][kTS]; sSt [N][kTS]; sCum [kL];
  // sRow, sZ, sCol [16][kRP] (padded to 16 bytes); sRed [warps].
  return sizeof(float) * (2 * kL * (N + 4) + 5 * kL * kTS + N * kTS + kL +
                          3 * ((16 * kRP + 3) / 4 * 4) + kThreads / 32);
}

// dx and d log_a of every head of the group, and the group's dB and dC.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_bwd_chunk_scan_kernel(const T* __restrict__ bm, const T* __restrict__ cm,
                              const T* __restrict__ x, const float* __restrict__ dy,
                              const float* __restrict__ s_in, const float* __restrict__ ds_out,
                              const float* __restrict__ cumbuf, float* __restrict__ dla,
                              T* __restrict__ dx, float* __restrict__ part, const Strides st,
                              int nheads, int seq, int chunk, int group) {
  constexpr int BS = N + 4;
  constexpr int Q = N / 16;   // state columns a thread owns: tx + 16 q
  constexpr int kPT = (16 * kRP + 3) / 4 * 4;
  extern __shared__ float smem[];
  float* sB = smem;               // [kL][BS]   B_j
  float* sC = sB + kL * BS;       // [kL][BS]   C_i
  float* sG = sC + kL * BS;       // [kL][kTS]  C_i . B_j
  float* sX = sG + kL * kTS;      // [kL][kTS]  x_j
  float* sDy = sX + kL * kTS;     // [kL][kTS]  dy_i
  float* sA = sDy + kL * kTS;     // [kL][kTS]  A = M o G
  float* sW = sA + kL * kTS;      // [kL][kTS]  W = M o D
  float* sSt = sW + kL * kTS;     // [N][kTS]   S, then dS'
  float* sCum = sSt + N * kTS;    // [kL]
  float* sRow = sCum + kL;        // [16][kRP]  row sums of A o D and C . dC_inter, by tx
  float* sZ = sRow + kPT;         // [16][kRP]  x . dx_inter, by tx
  float* sCol = sZ + kPT;         // [16][kRP]  column sums of A o D, by ty
  float* sRed = sCol + kPT;       // [warps]    <S, dS'>

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int lane = tid & 31;
  const int c = blockIdx.x;
  const int b = blockIdx.z;
  const int h0 = blockIdx.y * group;
  const int h1 = min(h0 + group, nheads);
  const int t0 = c * chunk;
  const int n_chunks = gridDim.x;
  const int valid = min(chunk, seq - t0);   // rows of the sub-chunk in the sequence
  const long long dy_t = static_cast<long long>(nheads) * kP;
  {
    Rows<N, T> rb, rc;
    rb.load(bm + b * st.b_b, st.b_t, t0, chunk, seq);
    rc.load(cm + b * st.c_b, st.c_t, t0, chunk, seq);
    rb.template store<BS>(sB);
    rc.template store<BS>(sC);
  }
  __syncthreads();
  {
    float g[4][4];
    zero(g);
    tile_mm<4, false, false>(g, sC, BS, sB, BS, 0, N);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) sG[(ty * 4 + i) * kTS + tx + 16 * q] = g[i][q];
  }
  float dBacc[4][Q];
  float dCacc[4][Q];
  zero(dBacc);
  zero(dCacc);

  for (int h = h0; h < h1; ++h) {
    const long long bch = (static_cast<long long>(b) * n_chunks + c) * nheads + h;
    __syncthreads();   // G is in; the previous head's reads are done
    {
      Rows<kP, T> rx;
      rx.load(x + b * st.x_b + h * st.x_h, st.x_t, t0, chunk, seq);
      rx.template store<kTS>(sX);
      Rows<kP, float> rd;
      rd.load(dy + static_cast<long long>(b) * seq * dy_t + h * kP, dy_t, t0, chunk, seq);
      rd.template store<kTS>(sDy);
    }
    load_state<N>(sSt, s_in + bch * N * kP);
    if (tid < kL) sCum[tid] = cumbuf[bch * kL + tid];
    __syncthreads();
    const float cum_last = sCum[kL - 1];
    float rowp[4] = {0.0f, 0.0f, 0.0f, 0.0f};   // this thread's share of each row's dcum
    float zp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    {
      // D = dy x^T; the mask before the exp; A, W stored; A o D summed.
      float d[4][4];
      zero(d);
      tile_mm<4, false, false>(d, sDy, kTS, sX, kTS, 0, kP);
      float colp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = ty * 4 + i;
        const float cr = sCum[row];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int col = tx + 16 * q;
          const bool causal = col <= row;
          const float diff = causal ? cr - sCum[col] : 0.0f;
          const float m = causal ? expf(diff) : 0.0f;
          const float a = m * sG[row * kTS + col];
          sA[row * kTS + col] = a;
          sW[row * kTS + col] = m * d[i][q];
          const float v = a * d[i][q];
          rowp[i] += v;
          colp[q] += v;
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) sCol[ty * kRP + tx + 16 * q] = colp[q];
    }
    {
      // dC_inter = exp(cum_i) (dy S^T), and its dcum term C_i . dC_inter_i.
      float ci[4][Q];
      zero(ci);
      tile_mm<Q, false, false>(ci, sDy, kTS, sSt, kTS, 0, kP);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = ty * 4 + i;
        const float e = expf(sCum[row]);
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const float v = ci[i][q] * e;
          dCacc[i][q] += v;
          rowp[i] += sC[row * BS + tx + 16 * q] * v;
        }
      }
    }
    __syncthreads();   // A, W and the column sums are in; the reads of S are done
    {
      // dS' over S, and <S, dS'>.
      constexpr int kIter = N * kP / (kThreads * 4);
      const float* src = ds_out + bch * N * kP;
      float4 v[kIter];
#pragma unroll
      for (int k = 0; k < kIter; ++k) v[k] = ld4(src + (tid + k * kThreads) * 4);
      float dot = 0.0f;
#pragma unroll
      for (int k = 0; k < kIter; ++k) {
        const int e = (tid + k * kThreads) * 4;
        float* dst = sSt + (e / kP) * kTS + e % kP;
        const float4 s = ld4(dst);
        dot += s.x * v[k].x + s.y * v[k].y + s.z * v[k].z + s.w * v[k].w;
        *reinterpret_cast<float4*>(dst) = v[k];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) sRed[tid >> 5] = dot;
    }
    __syncthreads();
    {
      // dx = A^T dy + w o (B dS'), and x . dx_inter.
      float xa[4][4];
      float xi[4][4];
      zero(xa);
      zero(xi);
      tile_mm<4, true, true>(xa, sA, kTS, sDy, kTS, ty * 4, kL);
      tile_mm<4, false, true>(xi, sB, BS, sSt, kTS, 0, N);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = ty * 4 + i;
        const float wj = expf(cum_last - sCum[j]);
        T* dxrow = dx + ((static_cast<long long>(b) * seq + t0 + j) * nheads + h) * kP;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = tx + 16 * q;
          const float inter = xi[i][q] * wj;
          zp[i] += sX[j * kTS + p] * inter;
          if (j < valid) from_f(xa[i][q] + inter, dxrow + p);
        }
      }
    }
    // dC += W B (j <= i); dB += W^T C (i >= j) + w o (x dS'^T).
    tile_mm<Q, false, true>(dCacc, sW, kTS, sB, BS, 0, ty * 4 + 4);
    tile_mm<Q, true, true>(dBacc, sW, kTS, sC, BS, ty * 4, kL);
    {
      float bi[4][Q];
      zero(bi);
      tile_mm<Q, false, false>(bi, sX, kTS, sSt, kTS, 0, kP);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float wj = expf(cum_last - sCum[ty * 4 + i]);
#pragma unroll
        for (int q = 0; q < Q; ++q) dBacc[i][q] += bi[i][q] * wj;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sRow[tx * kRP + ty * 4 + i] = rowp[i];
      sZ[tx * kRP + ty * 4 + i] = zp[i];
    }
    __syncthreads();
    if (tid < 32) {
      // dcum of rows 2 lane and 2 lane + 1, the last step's terms, then
      // d log_a as the reverse inclusive sum (over lanes from the top).
      float dc[2];
      float zsum = 0.0f;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int r = 2 * lane + k;
        float rs = 0.0f, cs = 0.0f, zs = 0.0f;
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          rs += sRow[u * kRP + r];
          cs += sCol[u * kRP + r];
          zs += sZ[u * kRP + r];
        }
        dc[k] = rs - cs - zs;
        zsum += zs;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) zsum += __shfl_xor_sync(0xffffffffu, zsum, off);
      float sdot = 0.0f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) sdot += sRed[w];
      if (lane == 31) dc[1] += expf(cum_last) * sdot + zsum;
      float suf = dc[0] + dc[1];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_down_sync(0xffffffffu, suf, off);
        if (lane + off < 32) suf += up;
      }
      float above = __shfl_down_sync(0xffffffffu, suf, 1);
      if (lane == 31) above = 0.0f;
      const float d1 = dc[1] + above;
      const float d0 = dc[0] + d1;
      float* out = dla + (static_cast<long long>(b) * seq + t0) * nheads + h;
      if (2 * lane < valid) out[static_cast<long long>(2 * lane) * nheads] = d0;
      if (2 * lane + 1 < valid) out[static_cast<long long>(2 * lane + 1) * nheads] = d1;
    }
  }
  // The group's dB and dC: part[which][b][c][group][row][n].
  const long long plane = static_cast<long long>(gridDim.z) * n_chunks * gridDim.y * kL * N;
  float* pb = part + ((static_cast<long long>(b) * n_chunks + c) * gridDim.y + blockIdx.y) * kL * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int idx = (ty * 4 + i) * N + tx + 16 * q;
      pb[idx] = dBacc[i][q];
      pb[plane + idx] = dCacc[i][q];
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
struct BwdDstate {
  template <typename T, int N>
  static cudaError_t run(const void* cm, const float* dy, const float* cumbuf, float* qbuf,
                         long long c_b, long long c_t, int batch, int nheads, int seq,
                         int chunk, int group, cudaStream_t stream) {
    auto k = ssd_bwd_chunk_dstate_kernel<T, N>;
    constexpr size_t bytes = bwd_dstate_smem_bytes<N>();
    cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((seq + chunk - 1) / chunk, (nheads + group - 1) / group, batch);
    k<<<grid, kThreads, bytes, stream>>>(static_cast<const T*>(cm), dy, cumbuf, qbuf, c_b, c_t,
                                         nheads, seq, chunk, group);
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
    constexpr size_t bytes = bwd_scan_smem_bytes<N>();
    cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((seq + chunk - 1) / chunk, (nheads + group - 1) / group, batch);
    k<<<grid, kThreads, bytes, stream>>>(
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
// scratch; qbuf (B, n_chunks, H, N, P), part (2, B, n_chunks, groups, 64,
// N), d log_a (B, T, H) float32, dx (B, T, H, P), dB and dC (B, T, N) in the
// operands' dtype, all contiguous.  n, chunk and group as ssd_scan_fwd.

extern "C" int ssd_bwd_chunk_dstate(const void* cm, const float* dy, const float* cumbuf,
                                    float* qbuf, long long c_b, long long c_t, int batch,
                                    int nheads, int seq, int n, int chunk, int group,
                                    int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (chunk < 1 || chunk > kL || group < 1 || group > kMaxGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(by_type<BwdDstate>(is_bf16, n, cm, dy, cumbuf, qbuf, c_b, c_t, batch,
                                             nheads, seq, chunk, group,
                                             static_cast<cudaStream_t>(stream)));
}

extern "C" int ssd_bwd_state_pass(float* qbuf, const float* cumbuf, const float* dfinal,
                                  int batch, int nheads, int n, int n_chunks, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(batch) * nheads * n * kP;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  ssd_bwd_state_pass_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      qbuf, cumbuf, dfinal, nheads, n * kP, n_chunks, total);
  return static_cast<int>(cudaGetLastError());
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
