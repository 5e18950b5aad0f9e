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
// bt[b, slot] (there is no scalar prefetch on this card) and streams each
// live page through shared memory in sub-tiles of at most TILE = 64 tokens
// as fp32, so the block's shared memory depends on rows and D only, never
// on the page size (a whole [256, 128] fp32 K+V page would need 265 KB, over
// the 227 KB a block may use). Sub-tiles past the context or wholly below
// the window are not read. Each warp runs an fp32 online softmax for its
// query rows (decode_tile.cuh, shared with flash_decode.cu). A sub-tile is
// loaded after the previous one is done: no copy/compute overlap yet
// (first version). A split with no live page emits m = -1e30, l = 0,
// o = 0 - a finite sentinel, so the merge of an idle slot gives 0 and never
// exp(-inf - -inf) = NaN.
#include "decode_tile.cuh"

namespace {

using namespace decode_tile;

// Python floor division / modulo (the TPU kernel's jnp semantics for the
// ring slot -> virtual page map, where ctx - 1 can be -1).
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}
__device__ __forceinline__ int pymod(int a, int b) { return a - floordiv(a, b) * b; }

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
  const int h = blockIdx.x % KVH;
  const int b = (blockIdx.x / KVH) % B;
  const int s = blockIdx.x / (KVH * B);

  extern __shared__ float smem[];
  float* qs = smem;                 // [rows, D]
  float* ks = qs + rows * D;        // [TILE, D + 1]
  float* vs = ks + TILE * (D + 1);  // [TILE, D]
  load_q(qs, q + (size_t)(b * KVH + h) * rows * D, rows, D);

  const int c = ctx[b], w = win[b];
  const float sqrt_d = sqrtf((float)D);
  const int lo_tok = w > 0 ? c - w : 0;
  const size_t tok_stride = (size_t)KVH * D;
  Rows<DPL, RPW> acc;

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

    const T* kb = kp + (size_t)pid * page * tok_stride + (size_t)h * D;
    const T* vb = vp + (size_t)pid * page * tok_stride + (size_t)h * D;
    // tokens of this page any row can see lie below c + qpos - 1
    const int t_end = min(page, c + qpos - 1 - vpg * page);
    for (int base = 0; base < t_end; base += TILE) {
      if (w > 0 && vpg * page + base + TILE <= lo_tok) continue;  // uniform
      const int n = min(TILE, t_end - base);
      load_tile(ks, vs, kb + (size_t)base * tok_stride,
                vb + (size_t)base * tok_stride, n, D, tok_stride);
      const int tok0 = vpg * page + base;
      acc.step(qs, ks, vs, n, rows, D, sqrt_d, [&](int r, int t) {
        const int hi = c + r % qpos;
        return tok0 + t < hi && (w <= 0 || tok0 + t >= hi - w);
      });
    }
  }
  acc.store(o, l, m, (((size_t)s * B + b) * KVH + h) * rows, rows, D);
}

struct Launch {
  template <typename T, int DPL, int RPW>
  static int run(const void* q, const void* k, const void* v, const void* bt,
                 const void* ctx, const void* win, void* o, void* l, void* m,
                 int B, int KVH, int rows, int D, int page, int W, int S,
                 int K, int ring_width, int windowed_slice, int qpos,
                 cudaStream_t stream) {
    const size_t smem = smem_bytes(rows, D);
    auto kern = paged_partials_kernel<T, DPL, RPW>;
    cudaError_t e = allow_smem(kern, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<S * B * KVH, WARPS * 32, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const int*)bt,
        (const int*)ctx, (const int*)win, (float*)o, (float*)l, (float*)m, B,
        KVH, rows, D, page, W, K, ring_width, windowed_slice, qpos);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// Dynamic shared memory one block needs: the [rows, D] q tile and one
// [TILE, D] K and V sub-tile as fp32, whatever the page size.
extern "C" long long paged_attention_smem(int rows, int D) {
  return (long long)smem_bytes(rows, D);
}

// dtype: 0 = float32, 1 = bfloat16 (q, K and V pages share it). The caller
// guarantees D <= 128, rows <= 32 and contiguous int32 bt/ctx/win. Returns
// cudaGetLastError() after the launch.
extern "C" int paged_attention_partials(
    int dtype, const void* q, const void* k, const void* v, const void* bt,
    const void* ctx, const void* win, void* o, void* l, void* m, int B,
    int KVH, int rows, int D, int page, int W, int S, int K, int ring_width,
    int windowed_slice, int qpos, void* stream) {
  return dispatch<Launch>(dtype, rows, D, q, k, v, bt, ctx, win, o, l, m, B,
                          KVH, rows, D, page, W, S, K, ring_width,
                          windowed_slice, qpos, (cudaStream_t)stream);
}
