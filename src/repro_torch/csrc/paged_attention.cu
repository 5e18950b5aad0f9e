// Paged split-K decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/paged_attention.py
// (_partials_kernel, called from paged_attention_partials): decode attention
// read straight out of the paged KV pool through the Va2Pa block table, each
// split emitting UNNORMALISED fp32 partials (o, l, m) for the log-sum-exp
// merge (the paper's EPU aggregation). Dead table slots cost nothing: -1
// pages, pages past the context, pages wholly below the sliding window and
// unwritten ring slots are skipped with the same liveness test as the TPU
// kernel (paged_attention.py:93).
//
// What bounds it: device-memory bandwidth. Every live K and V byte is read
// once and used for G*qpos query rows (4 on llama3.2-1b), far below the
// ~295 operations per byte where the H100's arithmetic would take over; the
// least time is (live K+V bytes) / 3.35 TB/s (backend.decode_hbm_bytes).
//
// Design: one thread block per (split, batch row, kv head) - the TPU grid's
// sequential slot axis becomes a loop inside the block, since blocks run in
// no order and carry nothing between them. The block reads its own
// bt[b, slot] (there is no scalar prefetch on this card), copies the live
// [page, D] K and V tiles into shared memory as fp32, and each warp runs an
// fp32 online softmax for its query rows with m, l and the accumulator in
// registers. Scores are computed one key token per lane (K tile padded to
// D+1 floats a row so the lanes hit distinct banks); P.V broadcasts each
// lane's probability with a shuffle while every lane owns D/32 output
// columns. K and V tiles are loaded after the block's previous page is done:
// no copy/compute overlap yet (first version). A split with no live page
// emits m = -1e30, l = 0, o = 0 - a finite sentinel, so the merge of an
// idle slot gives 0 and never exp(-inf - -inf) = NaN.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Python floor division / modulo (the TPU kernel's jnp semantics for the
// ring slot -> virtual page map, where ctx - 1 can be -1).
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}
__device__ __forceinline__ int pymod(int a, int b) { return a - floordiv(a, b) * b; }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// q [B, KVH, rows, D]; kp/vp [P, page, KVH, D]; bt [B, W]; ctx, win [B];
// o [S, B, KVH, rows, D]; l, m [S, B, KVH, rows]. Row r of the q tile sits at
// position ctx - 1 + r % qpos. Split s owns table slots [s*K, s*K + K); slots
// at or past W are the tail split's padding and are dead.
template <typename T, int DPL, int RPW>
__global__ void __launch_bounds__(WARPS * 32)
paged_partials_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                      const T* __restrict__ vp, const int* __restrict__ bt,
                      const int* __restrict__ ctx, const int* __restrict__ win,
                      float* __restrict__ o, float* __restrict__ l,
                      float* __restrict__ m, int B, int KVH, int rows, int D,
                      int page, int W, int K, int ring_width,
                      int windowed_slice, int qpos) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x % KVH;
  const int b = (blockIdx.x / KVH) % B;
  const int s = blockIdx.x / (KVH * B);
  const int ldk = D + 1;

  extern __shared__ float smem[];
  float* qs = smem;                 // [rows, D]
  float* ks = qs + rows * D;        // [page, D + 1]
  float* vs = ks + page * ldk;      // [page, D]

  const T* qb = q + (size_t)(b * KVH + h) * rows * D;
  for (int i = tid; i < rows * D; i += blockDim.x) qs[i] = to_f(qb[i]);

  const int c = ctx[b], w = win[b];
  const float sqrt_d = sqrtf((float)D);
  const int lo_tok = w > 0 ? c - w : 0;
  const size_t tok_stride = (size_t)KVH * D;

  float acc[RPW][DPL], mrow[RPW], lrow[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    mrow[i] = NEG_INF;
    lrow[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc[i][dd] = 0.f;
  }

  for (int j = 0; j < K; ++j) {
    const int slot = s * K + j;
    if (slot >= W) break;
    int vpg;
    if (ring_width) {
      const int cur = floordiv(c - 1, page);
      vpg = cur - pymod(cur - slot, ring_width);   // < 0: never written
    } else if (windowed_slice) {
      vpg = max(c - w, 0) / page + slot;
    } else {
      vpg = slot;
    }
    const int pid = bt[(size_t)b * W + slot];
    const bool live = pid >= 0 && vpg >= 0 && vpg * page < c + qpos - 1 &&
                      (vpg + 1) * page > lo_tok;
    if (!live) continue;   // uniform over the block

    __syncthreads();       // previous page's reads of ks/vs are done
    const T* kb = kp + (size_t)pid * page * tok_stride + (size_t)h * D;
    const T* vb = vp + (size_t)pid * page * tok_stride + (size_t)h * D;
    for (int i = tid; i < page * D; i += blockDim.x) {
      const int t = i / D, d = i - t * D;
      ks[t * ldk + d] = to_f(kb[t * tok_stride + d]);
      vs[t * D + d] = to_f(vb[t * tok_stride + d]);
    }
    __syncthreads();

    for (int t0 = 0; t0 < page; t0 += 32) {
      const int t = t0 + lane;
      const bool tin = t < page;
      const int tok = vpg * page + t;
      const int nt = min(32, page - t0);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int r = warp + WARPS * i;
        if (r >= rows) break;   // warp-uniform
        float sc = 0.f;
        if (tin) {
          const float* qr = qs + r * D;
          const float* kr = ks + t * ldk;
          for (int d = 0; d < D; ++d) sc = fmaf(qr[d], kr[d], sc);
        }
        sc = sc / sqrt_d;
        const int hi = c + r % qpos;
        const int lo = w > 0 ? hi - w : 0;
        const bool ok = tin && tok < hi && tok >= lo;
        sc = ok ? sc : NEG_INF;
        const float m_new = fmaxf(mrow[i], warp_max(sc));
        const float p = ok ? expf(sc - m_new) : 0.f;
        const float corr = expf(mrow[i] - m_new);
        lrow[i] = lrow[i] * corr + warp_sum(p);
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) acc[i][dd] *= corr;
        for (int jj = 0; jj < nt; ++jj) {
          const float pj = __shfl_sync(FULL, p, jj);
          const float* vr = vs + (t0 + jj) * D;
#pragma unroll
          for (int dd = 0; dd < DPL; ++dd) {
            const int d = lane + 32 * dd;
            if (d < D) acc[i][dd] = fmaf(pj, vr[d], acc[i][dd]);
          }
        }
        mrow[i] = m_new;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + WARPS * i;
    if (r >= rows) break;
    const size_t row = (((size_t)s * B + b) * KVH + h) * rows + r;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) {
      const int d = lane + 32 * dd;
      if (d < D) o[row * D + d] = acc[i][dd];
    }
    if (lane == 0) {
      l[row] = lrow[i];
      m[row] = mrow[i];
    }
  }
}

template <typename T, int DPL, int RPW>
int launch(const void* q, const void* k, const void* v, const void* bt,
           const void* ctx, const void* win, void* o, void* l, void* m, int B,
           int KVH, int rows, int D, int page, int W, int S, int K,
           int ring_width, int windowed_slice, int qpos, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)rows * D + (size_t)page * (D + 1) +
                                       (size_t)page * D);
  auto kern = paged_partials_kernel<T, DPL, RPW>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<S * B * KVH, WARPS * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)bt, (const int*)ctx,
      (const int*)win, (float*)o, (float*)l, (float*)m, B, KVH, rows, D, page,
      W, K, ring_width, windowed_slice, qpos);
  return (int)cudaGetLastError();
}

template <typename T, int DPL>
int by_rows(int rpw, const void* q, const void* k, const void* v,
            const void* bt, const void* ctx, const void* win, void* o, void* l,
            void* m, int B, int KVH, int rows, int D, int page, int W, int S,
            int K, int ring, int ws, int qpos, cudaStream_t st) {
#define PA_ARGS q, k, v, bt, ctx, win, o, l, m, B, KVH, rows, D, page, W, S, K, ring, ws, qpos, st
  if (rpw <= 1) return launch<T, DPL, 1>(PA_ARGS);
  if (rpw <= 2) return launch<T, DPL, 2>(PA_ARGS);
  if (rpw <= 4) return launch<T, DPL, 4>(PA_ARGS);
  return launch<T, DPL, 8>(PA_ARGS);
#undef PA_ARGS
}

template <typename T>
int by_width(int rpw, int dpl, const void* q, const void* k, const void* v,
             const void* bt, const void* ctx, const void* win, void* o,
             void* l, void* m, int B, int KVH, int rows, int D, int page,
             int W, int S, int K, int ring, int ws, int qpos,
             cudaStream_t st) {
#define PA_ARGS rpw, q, k, v, bt, ctx, win, o, l, m, B, KVH, rows, D, page, W, S, K, ring, ws, qpos, st
  if (dpl <= 1) return by_rows<T, 1>(PA_ARGS);
  if (dpl <= 2) return by_rows<T, 2>(PA_ARGS);
  return by_rows<T, 4>(PA_ARGS);
#undef PA_ARGS
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, K and V pages share it). The caller
// guarantees D <= 128, rows <= 32 and contiguous int32 bt/ctx/win. Returns
// cudaGetLastError() after the launch.
extern "C" int paged_attention_partials(
    int dtype, const void* q, const void* k, const void* v, const void* bt,
    const void* ctx, const void* win, void* o, void* l, void* m, int B,
    int KVH, int rows, int D, int page, int W, int S, int K, int ring_width,
    int windowed_slice, int qpos, void* stream) {
  const int rpw = (rows + WARPS - 1) / WARPS;
  const int dpl = (D + 31) / 32;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return by_width<__nv_bfloat16>(rpw, dpl, q, k, v, bt, ctx, win, o, l, m,
                                   B, KVH, rows, D, page, W, S, K, ring_width,
                                   windowed_slice, qpos, st);
  return by_width<float>(rpw, dpl, q, k, v, bt, ctx, win, o, l, m, B, KVH,
                         rows, D, page, W, S, K, ring_width, windowed_slice,
                         qpos, st);
}
