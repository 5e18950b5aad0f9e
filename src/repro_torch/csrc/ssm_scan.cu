// Mamba2 chunked gated-linear-attention scan for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel repro/kernels/ssm_scan.py (_kernel, called
// from ssm_chunk_scan). It computes models/ssm.py::chunked_gla with
// normalize=False for one (batch row, head) per thread block: for each chunk
// of c <= 128 tokens, with bcum = cumsum(log_a) (inclusive), btot = bcum[-1],
//   W_ij = exp(clip(bcum_i - bcum_j + log_g_j, -1e30, 60)) for i >= j, else 0
//   y    = (q k^T . W) v + exp(bcum) . (q C)
//   sc_j = exp(clip(btot - bcum_j + log_g_j, -1e30, 60))
//   C   <- C exp(btot) + (k . sc)^T v,   n <- n exp(btot) + sum_j k_j sc_j
// The TPU kernel returns only C; this one also carries n (Mamba2 never reads
// it, but the serving state holds it), so the state equals the JAX state
// leaf for leaf.
//
// What bounds it on this card: at decode (S = 1) bytes - each step reads and
// writes the [N, P] fp32 state of every (b, h), a rank-1 update of it is all
// the arithmetic. At prefill (chunk 128) operations - the four small products
// per chunk (q k^T, S v, q C, k^T v), about 2 c N + 2 c P + 4 N P operations
// per token and head on the causal half. This first version runs on the fp32
// CUDA cores (67 TFLOP/s), not the tensor cores.
//
// Design. The TPU grid's chunk axis is sequential (the state lives in VMEM
// scratch across grid steps); blocks on Hopper carry nothing between them,
// so the chunk loop runs inside the block and the [N, P] state stays in
// shared memory for the whole sequence, read from device memory once and
// written once. Per chunk the block stages q, k, v (upcast to fp32) and the
// [c, c] score tile in dynamic shared memory (184 KB at c = 128,
// N = P = 64; rows padded by one float so strided reads hit distinct banks).
// Every product is one routine: 256 threads as a 16 x 16 grid, each owning a
// 4 x 4 micro-tile of a 64 x 64 output tile (rows ty + 16 r, cols tx + 16 c),
// accumulating in registers. Score tiles wholly above the diagonal are
// skipped. q and k are read through explicit element strides, so the
// Mamba2 caller passes its head-broadcast (stride-0) views without copying
// them to every head. Masked positions arrive as log_a = 0, log_g = -1e30;
// the clip sends them to exp(-1e30) = 0, never to NaN.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TX = 16;             // thread grid of one output tile: 16 x 16
constexpr int MT = 4;              // 4 x 4 outputs per thread
constexpr int TILE = TX * MT;      // 64 x 64 output tile
constexpr int MAX_CHUNK = 128;     // 4 cumsum entries per lane of warp 0
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t MAX_SMEM = 232448;

struct Strides {                   // element strides of q, k, v: (b, s, h, d)
  long long q[4], k[4], v[4];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float clip_exp(float x) {
  return expf(fminf(fmaxf(x, NEG_INF), 60.f));
}

// acc[r][c] += sum_{kk < K} A[row_r*sam + kk*sak] * B[kk*sbk + col_c*sbn]
// with row_r = row0 + ty + 16 r and col_c = col0 + tx + 16 c. Rows >= M and
// cols >= NC read a clamped row / col; the caller drops those results.
__device__ __forceinline__ void mm_acc(float (&acc)[MT][MT], const float* A,
                                       int sam, int sak, const float* B,
                                       int sbk, int sbn, int row0, int col0,
                                       int M, int NC, int K, int ty, int tx) {
  int ar[MT], bcol[MT];
#pragma unroll
  for (int r = 0; r < MT; ++r) ar[r] = min(row0 + ty + TX * r, M - 1) * sam;
#pragma unroll
  for (int c = 0; c < MT; ++c) bcol[c] = min(col0 + tx + TX * c, NC - 1) * sbn;
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    float a[MT], b[MT];
#pragma unroll
    for (int r = 0; r < MT; ++r) a[r] = A[ar[r] + kk * sak];
#pragma unroll
    for (int c = 0; c < MT; ++c) b[c] = B[kk * sbk + bcol[c]];
#pragma unroll
    for (int r = 0; r < MT; ++r)
#pragma unroll
      for (int c = 0; c < MT; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[MT][MT]) {
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int c = 0; c < MT; ++c) acc[r][c] = 0.f;
}

size_t smem_floats(int N, int P, int chunk) {
  const size_t ldq = N + 1, ldv = P + 1, lds = chunk + 1;
  return (size_t)N * ldv + 2 * (size_t)chunk * ldq + (size_t)chunk * ldv +
         (size_t)chunk * lds + 3 * (size_t)chunk + N;
}

// q, k [B, S, H, N] and v [B, S, H, P] of type T at the given strides;
// la, lg [B, S, H] fp32 contiguous; c0 [B, H, N, P] and n0 [B, H, N] fp32
// contiguous or null (zeros); y [B, S, H, P], c_out, n_out fp32 contiguous.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssm_scan_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ la,
                const float* __restrict__ lg, const float* __restrict__ c0,
                const float* __restrict__ n0, float* __restrict__ y,
                float* __restrict__ c_out, float* __restrict__ n_out,
                Strides st, int S, int H, int N, int P, int chunk) {
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x % H, b = blockIdx.x / H;
  const int ldq = N + 1, ldv = P + 1, lds = chunk + 1;

  extern __shared__ float sm[];
  float* Cs = sm;                    // [N, P + 1] carried state
  float* qs = Cs + N * ldv;          // [c, N + 1]
  float* ks = qs + chunk * ldq;      // [c, N + 1]
  float* vs = ks + chunk * ldq;      // [c, P + 1]
  float* ss = vs + chunk * ldv;      // [c, c + 1] weighted scores
  float* bc = ss + chunk * lds;      // [c] inclusive cumsum of log_a
  float* lgs = bc + chunk;           // [c] log_g
  float* scs = lgs + chunk;          // [c] state-handoff scale
  float* ns = scs + chunk;           // [N] carried n

  const size_t bh = (size_t)b * H + h;
  for (int idx = tid; idx < N * P; idx += THREADS)
    Cs[(idx / P) * ldv + idx % P] = c0 ? c0[bh * N * P + idx] : 0.f;
  for (int idx = tid; idx < N; idx += THREADS)
    ns[idx] = n0 ? n0[bh * N + idx] : 0.f;

  const T* qb = q + b * st.q[0] + h * st.q[2];
  const T* kb = k + b * st.k[0] + h * st.k[2];
  const T* vb = v + b * st.v[0] + h * st.v[2];
  const int n_chunks = S / chunk;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * chunk;
    __syncthreads();   // the previous chunk is done with every tile
    for (int idx = tid; idx < chunk * N; idx += THREADS) {
      const int i = idx / N, d = idx - i * N;
      qs[i * ldq + d] = to_f(qb[(t0 + i) * st.q[1] + d * st.q[3]]);
      ks[i * ldq + d] = to_f(kb[(t0 + i) * st.k[1] + d * st.k[3]]);
    }
    for (int idx = tid; idx < chunk * P; idx += THREADS) {
      const int i = idx / P, p = idx - i * P;
      vs[i * ldv + p] = to_f(vb[(t0 + i) * st.v[1] + p * st.v[3]]);
    }
    for (int i = tid; i < chunk; i += THREADS) {
      const size_t g = ((size_t)b * S + t0 + i) * H + h;
      bc[i] = la[g];
      lgs[i] = lg[g];
    }
    __syncthreads();
    if (warp == 0) {   // inclusive cumsum of log_a: 4 entries a lane
      float loc[MAX_CHUNK / 32], s = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_CHUNK / 32; ++r) {
        const int i = lane * (MAX_CHUNK / 32) + r;
        s += i < chunk ? bc[i] : 0.f;
        loc[r] = s;
      }
      float incl = s;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += t;
      }
      float excl = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) excl = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_CHUNK / 32; ++r) {
        const int i = lane * (MAX_CHUNK / 32) + r;
        if (i < chunk) bc[i] = excl + loc[r];
      }
    }
    __syncthreads();
    const float btot = bc[chunk - 1];
    for (int i = tid; i < chunk; i += THREADS)
      scs[i] = clip_exp(btot - bc[i] + lgs[i]);

    // (a) ss_ij = (q_i . k_j) W_ij on and below the diagonal
    for (int mi = 0; mi < chunk; mi += TILE)
      for (int nj = 0; nj <= mi; nj += TILE) {
        float acc[MT][MT];
        zero(acc);
        mm_acc(acc, qs, ldq, 1, ks, 1, ldq, mi, nj, chunk, chunk, N, ty, tx);
#pragma unroll
        for (int r = 0; r < MT; ++r)
#pragma unroll
          for (int c = 0; c < MT; ++c) {
            const int i = mi + ty + TX * r, j = nj + tx + TX * c;
            if (i < chunk && j < chunk)
              ss[i * lds + j] =
                  j <= i ? acc[r][c] * clip_exp(bc[i] - bc[j] + lgs[j]) : 0.f;
          }
      }
    __syncthreads();

    // (b) y_i = sum_{j <= i} ss_ij v_j + exp(bcum_i) (q_i C)
    for (int mi = 0; mi < chunk; mi += TILE)
      for (int pj = 0; pj < P; pj += TILE) {
        float acc[MT][MT], inter[MT][MT];
        zero(acc);
        zero(inter);
        mm_acc(acc, ss, lds, 1, vs, ldv, 1, mi, pj, chunk, P,
               min(chunk, mi + TILE), ty, tx);
        mm_acc(inter, qs, ldq, 1, Cs, ldv, 1, mi, pj, chunk, P, N, ty, tx);
#pragma unroll
        for (int r = 0; r < MT; ++r) {
          const int i = mi + ty + TX * r;
          if (i >= chunk) continue;
          const float w = expf(bc[i]);
          float* yr = y + (((size_t)b * S + t0 + i) * H + h) * P;
#pragma unroll
          for (int c = 0; c < MT; ++c) {
            const int p = pj + tx + TX * c;
            if (p < P) yr[p] = acc[r][c] + inter[r][c] * w;
          }
        }
      }
    __syncthreads();   // every read of the old C is done

    // (c) state handoff
    for (int idx = tid; idx < chunk * N; idx += THREADS) {
      const int i = idx / N;
      ks[i * ldq + idx - i * N] *= scs[i];
    }
    __syncthreads();
    const float carry = expf(btot);
    for (int mi = 0; mi < N; mi += TILE)
      for (int pj = 0; pj < P; pj += TILE) {
        float acc[MT][MT];
        zero(acc);
        mm_acc(acc, ks, 1, ldq, vs, ldv, 1, mi, pj, N, P, chunk, ty, tx);
#pragma unroll
        for (int r = 0; r < MT; ++r)
#pragma unroll
          for (int c = 0; c < MT; ++c) {
            const int n = mi + ty + TX * r, p = pj + tx + TX * c;
            if (n < N && p < P)
              Cs[n * ldv + p] = Cs[n * ldv + p] * carry + acc[r][c];
          }
      }
    for (int d = tid; d < N; d += THREADS) {
      float s = 0.f;
      for (int j = 0; j < chunk; ++j) s += ks[j * ldq + d];
      ns[d] = ns[d] * carry + s;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < N * P; idx += THREADS)
    c_out[bh * N * P + idx] = Cs[(idx / P) * ldv + idx % P];
  for (int idx = tid; idx < N; idx += THREADS) n_out[bh * N + idx] = ns[idx];
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* la,
           const void* lg, const void* c0, const void* n0, void* y,
           void* c_out, void* n_out, const Strides& st, int B, int S, int H,
           int N, int P, int chunk, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(N, P, chunk);
  auto kern = ssm_scan_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<B * H, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)la,
      (const float*)lg, (const float*)c0, (const float*)n0, (float*)y,
      (float*)c_out, (float*)n_out, st, S, H, N, P, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory one block needs, in bytes (the wrapper refuses
// shapes above the card's 232448).
extern "C" long long ssm_chunk_scan_smem(int N, int P, int chunk) {
  return (long long)(sizeof(float) * smem_floats(N, P, chunk));
}

// dtype: 0 = float32, 1 = bfloat16 (q, k and v share it); strides: 12
// element strides, (b, s, h, d) of q, then k, then v. c0 / n0 may be null
// (a fresh sequence). The caller guarantees 1 <= chunk <= 128, S % chunk ==
// 0 and contiguous fp32 la, lg, c0, n0, y, c_out, n_out. Returns
// cudaGetLastError() after the launch.
extern "C" int ssm_chunk_scan(int dtype, const void* q, const void* k,
                              const void* v, const void* la, const void* lg,
                              const void* c0, const void* n0, void* y,
                              void* c_out, void* n_out,
                              const long long* strides, int B, int S, int H,
                              int N, int P, int chunk, void* stream) {
  if (chunk < 1 || chunk > MAX_CHUNK || S % chunk ||
      sizeof(float) * smem_floats(N, P, chunk) > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 4; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[4 + i];
    st.v[i] = strides[8 + i];
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, la, lg, c0, n0, y, c_out, n_out, st,
                                 B, S, H, N, P, chunk, s);
  return launch<float>(q, k, v, la, lg, c0, n0, y, c_out, n_out, st, B, S, H,
                       N, P, chunk, s);
}
