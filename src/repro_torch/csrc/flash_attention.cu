// Causal / windowed GQA flash attention forward for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py (_kernel,
// called from flash_attention_fwd). It computes the same normalised output;
// on the card it carries prefill and chunked prefill, where the JAX model
// calls the jnp models/layers.flash_attention. Two differences from the TPU
// kernel, both needed by prefill_chunk: a per-row [B] int32 q_offset (each
// request resumes at its own depth) and a ragged Sq / Skv, masked instead of
// asserted divisible. Key tiles wholly past the causal frontier of a query
// tile, or wholly below its window, are skipped (the TPU kernel streams them
// and masks them out; the function is the same).
//
// What bounds it: at prefill lengths, the arithmetic - 4*B*H*D operations
// per causal (query, key) pair against q, k, v and o read or written once.
// This first version runs on the fp32 CUDA cores (67 TFLOP/s), not the
// tensor cores; wgmma, TMA and warp specialisation are later work.
//
// Design: one thread block per (batch row, kv head, query tile). The block
// covers all G query heads of its kv head (64 rows = G heads x 64/G query
// positions), so K and V are loaded once per tile for the whole group and
// never repeated. It walks 32-token K/V tiles through shared memory (fp32;
// K padded to D+1 floats a row so lanes hit distinct banks). Each warp owns
// 16 rows with an fp32 online softmax - m, l and the accumulator in
// registers; scores are one key per lane, P.V broadcasts each lane's
// probability with a shuffle while every lane owns D/32 output columns. As
// in the TPU kernel, probabilities are rounded to the value type before P.V
// and the output is divided by max(l, 1e-30).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int RPW = 16;             // rows per warp
constexpr int ROWS = WARPS * RPW;   // rows per block
constexpr int KV_TILE = 32;         // one key per lane
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}
// p.astype(v.dtype) of the TPU kernel before the P.V product
__device__ __forceinline__ float round_like(float x, const float*) { return x; }
__device__ __forceinline__ float round_like(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// q [B, Sq, H, D]; k/v [B, Skv, KVH, D]; out [B, Sq, H, D]; q_off [B].
// Query row i of batch row b sits at position q_off[b] + i.
template <typename T, int DPL>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 const int* __restrict__ q_off, int B, int Sq, int Skv, int H,
                 int KVH, int D, int G, int qblk, int n_qt, int causal,
                 int window) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qt = blockIdx.x % n_qt;
  const int h = (blockIdx.x / n_qt) % KVH;
  const int b = blockIdx.x / (n_qt * KVH);
  const int rows = G * qblk;
  const int ldk = D + 1;

  extern __shared__ float smem[];
  float* qs = smem;                  // [ROWS, D]
  float* ks = qs + ROWS * D;         // [KV_TILE, D + 1]
  float* vs = ks + KV_TILE * ldk;    // [KV_TILE, D]

  const int off = q_off[b];
  const int q0 = qt * qblk;
  // row r -> (head g = r / qblk, query i = q0 + r % qblk)
  for (int idx = tid; idx < rows * D; idx += blockDim.x) {
    const int r = idx / D, d = idx - r * D;
    const int g = r / qblk, i = q0 + r % qblk;
    qs[idx] = i < Sq ? to_f(q[(((size_t)b * Sq + i) * H + h * G + g) * D + d])
                     : 0.f;
  }

  const int q_last = min(q0 + qblk, Sq) - 1;
  int kv_hi = Skv;
  if (causal) kv_hi = min(Skv, off + q_last + 1);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, off + q0 - window + 1);
  kv_lo = (kv_lo / KV_TILE) * KV_TILE;

  const float sqrt_d = sqrtf((float)D);
  const size_t k_stride = (size_t)KVH * D;
  const T* kb = k + (size_t)b * Skv * k_stride + (size_t)h * D;
  const T* vb = v + (size_t)b * Skv * k_stride + (size_t)h * D;

  float acc[RPW][DPL], mrow[RPW], lrow[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    mrow[i] = NEG_INF;
    lrow[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc[i][dd] = 0.f;
  }

  for (int t0 = kv_lo; t0 < kv_hi; t0 += KV_TILE) {
    __syncthreads();   // previous tile's reads of ks/vs are done
    for (int idx = tid; idx < KV_TILE * D; idx += blockDim.x) {
      const int t = idx / D, d = idx - t * D;
      const bool in = t0 + t < Skv;
      ks[t * ldk + d] = in ? to_f(kb[(t0 + t) * k_stride + d]) : 0.f;
      vs[t * D + d] = in ? to_f(vb[(t0 + t) * k_stride + d]) : 0.f;
    }
    __syncthreads();

    const int kv = t0 + lane;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp * RPW + i;
      if (r >= rows) break;   // warp-uniform
      const int qpos = off + q0 + r % qblk;
      const float* qr = qs + r * D;
      const float* kr = ks + lane * ldk;
      float sc = 0.f;
      for (int d = 0; d < D; ++d) sc = fmaf(qr[d], kr[d], sc);
      sc = sc / sqrt_d;
      bool ok = kv < Skv;
      if (causal) ok = ok && kv <= qpos;
      if (window > 0) ok = ok && kv > qpos - window;
      sc = ok ? sc : NEG_INF;
      const float m_new = fmaxf(mrow[i], warp_max(sc));
      const float p = ok ? expf(sc - m_new) : 0.f;
      const float corr = expf(mrow[i] - m_new);
      lrow[i] = lrow[i] * corr + warp_sum(p);
      const float pv = round_like(p, kb);
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) acc[i][dd] *= corr;
#pragma unroll 4
      for (int j = 0; j < KV_TILE; ++j) {
        const float pj = __shfl_sync(FULL, pv, j);
        const float* vr = vs + j * D;
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) {
          const int d = lane + 32 * dd;
          if (d < D) acc[i][dd] = fmaf(pj, vr[d], acc[i][dd]);
        }
      }
      mrow[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp * RPW + i;
    if (r >= rows) break;
    const int g = r / qblk, qi = q0 + r % qblk;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(lrow[i], 1e-30f);
    T* orow = out + (((size_t)b * Sq + qi) * H + h * G + g) * D;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) {
      const int d = lane + 32 * dd;
      if (d < D) from_f(acc[i][dd] * inv, orow + d);
    }
  }
}

template <typename T, int DPL>
int launch(const void* q, const void* k, const void* v, void* out,
           const void* q_off, int B, int Sq, int Skv, int H, int KVH, int D,
           int causal, int window, cudaStream_t stream) {
  const int G = H / KVH;
  const int qblk = ROWS / G;
  const int n_qt = (Sq + qblk - 1) / qblk;
  const size_t smem = sizeof(float) * ((size_t)ROWS * D +
                                       (size_t)KV_TILE * (D + 1) +
                                       (size_t)KV_TILE * D);
  auto kern = flash_fwd_kernel<T, DPL>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<B * KVH * n_qt, WARPS * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (const int*)q_off, B,
      Sq, Skv, H, KVH, D, G, qblk, n_qt, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int by_width(int dpl, const void* q, const void* k, const void* v, void* out,
             const void* q_off, int B, int Sq, int Skv, int H, int KVH, int D,
             int causal, int window, cudaStream_t st) {
#define FA_ARGS q, k, v, out, q_off, B, Sq, Skv, H, KVH, D, causal, window, st
  if (dpl <= 1) return launch<T, 1>(FA_ARGS);
  if (dpl <= 2) return launch<T, 2>(FA_ARGS);
  return launch<T, 4>(FA_ARGS);
#undef FA_ARGS
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). The caller
// guarantees D <= 128, H % KVH == 0, H / KVH <= 64, contiguous tensors and an
// int32 q_off [B]. Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* out, const void* q_off,
                                   int B, int Sq, int Skv, int H, int KVH,
                                   int D, int causal, int window,
                                   void* stream) {
  const int dpl = (D + 31) / 32;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return by_width<__nv_bfloat16>(dpl, q, k, v, out, q_off, B, Sq, Skv, H,
                                   KVH, D, causal, window, st);
  return by_width<float>(dpl, q, k, v, out, q_off, B, Sq, Skv, H, KVH, D,
                         causal, window, st);
}
