// ITPP split-K decode attention partials over a contiguous cache, for
// Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode.py (_kernel,
// called from flash_decode): the paper's token-partitioned attention
// (section 4.3). The K/V cache of each (batch row, kv head) is cut along
// the TOKEN axis into S splits of ceil(T / S) tokens; each split emits
// UNNORMALISED fp32 partials (o, l, m) for the stable log-sum-exp merge
// (the EPU aggregation). The TPU kernel zero-pads the tail split
// (jnp.pad) and masks tok >= min(ctx, T); here nothing is padded: tokens
// at or past min(ctx, T) are never read.
//
// What bounds it: device-memory bandwidth. Every live K and V byte is read
// once and used for the G query rows of its kv head (4 at the shapes this
// repo runs), far below the ~295 operations per byte where the H100's
// arithmetic would take over; the least time is the live K+V bytes over
// 3.35 TB/s. Dead tokens (past the context) cost nothing: unlike the TPU
// kernel, which streams whole dead splits, a block reads only the live
// part of its split, and a split with no live token reads no K/V at all.
//
// Design (first version, right before fast): one thread block per
// (split, batch row, kv head), as the TPU grid (B, KVH, S). The TPU keeps a
// whole [split, D] K and V tile in VMEM; a split here can be thousands of
// tokens (501 at the bench shape, 513 KB of fp32 K+V), far over the 227 KB
// of shared memory a block may use, so the block walks its split in tiles
// of TILE = 64 tokens, converted to fp32 in shared memory, with an fp32
// online softmax across tiles (decode_tile.cuh, shared with the paged
// kernel). The G query rows sit in shared memory; each warp owns rows warp,
// warp + 4, ... with m, l and the accumulator in registers. The final m is
// the exact max over the split's live scores (the running max), as in the
// one-shot Pallas body; l and o agree up to the order of summation. A split with no live token emits exactly m = -1e30,
// l = 0, o = 0 (the Pallas body's values for an all-masked split), so a
// ctx = 0 row merges to 0, never NaN. Tiles are loaded after the previous
// one is done: no copy/compute overlap yet (TMA or cp.async double
// buffering, several splits a block: later work).
#include "decode_tile.cuh"

namespace {

using namespace decode_tile;

// q [B, KVH, G, D]; k/v [B, T, KVH, D]; ctx [B]; o [S, B, KVH, G, D];
// l, m [S, B, KVH, G]. Split s owns tokens [s*split, (s+1)*split); the live
// ones are those below min(ctx, T).
template <typename T, int DPL, int RPW>
__global__ void __launch_bounds__(WARPS * 32)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ ctx,
                    float* __restrict__ o, float* __restrict__ l,
                    float* __restrict__ m, int B, int KVH, int G, int D,
                    int Tlen, int split) {
  const int h = blockIdx.x % KVH;
  const int b = (blockIdx.x / KVH) % B;
  const int s = blockIdx.x / (KVH * B);

  extern __shared__ float smem[];
  float* qs = smem;                 // [G, D]
  float* ks = qs + G * D;           // [TILE, D + 1]
  float* vs = ks + TILE * (D + 1);  // [TILE, D]
  load_q(qs, q + (size_t)(b * KVH + h) * G * D, G, D);

  const int c = min(ctx[b], Tlen);          // the ctx clamp of the TPU kernel
  const int hi = min(s * split + split, c); // live tokens [s * split, hi)
  const float sqrt_d = sqrtf((float)D);
  const size_t tok_stride = (size_t)KVH * D;
  const T* kb = k + ((size_t)b * Tlen * KVH + h) * D;
  const T* vb = v + ((size_t)b * Tlen * KVH + h) * D;
  Rows<DPL, RPW> acc;

  for (int base = s * split; base < hi; base += TILE) {
    const int n = min(TILE, hi - base);
    load_tile(ks, vs, kb + (size_t)base * tok_stride,
              vb + (size_t)base * tok_stride, n, D, tok_stride);
    acc.step(qs, ks, vs, n, G, D, sqrt_d, [](int, int) { return true; });
  }
  acc.store(o, l, m, (((size_t)s * B + b) * KVH + h) * G, G, D);
}

struct Launch {
  template <typename T, int DPL, int RPW>
  static int run(const void* q, const void* k, const void* v,
                 const void* ctx, void* o, void* l, void* m, int B, int KVH,
                 int G, int D, int Tlen, int S, int split,
                 cudaStream_t stream) {
    const size_t smem = smem_bytes(G, D);
    auto kern = flash_decode_kernel<T, DPL, RPW>;
    cudaError_t e = allow_smem(kern, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<S * B * KVH, WARPS * 32, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const int*)ctx, (float*)o,
        (float*)l, (float*)m, B, KVH, G, D, Tlen, split);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// Dynamic shared memory one block needs: the [G, D] q tile and one
// [TILE, D] K and V tile as fp32, whatever the split length.
extern "C" long long flash_decode_smem(int G, int D) {
  return (long long)smem_bytes(G, D);
}

// dtype: 0 = float32, 1 = bfloat16 (q, K and V share it). The caller
// guarantees D <= 128, G <= 32, contiguous q/k/v and int32 ctx, and
// split = ceil(T / S). Returns cudaGetLastError() after the launch.
extern "C" int flash_decode(int dtype, const void* q, const void* k,
                            const void* v, const void* ctx, void* o, void* l,
                            void* m, int B, int KVH, int G, int D, int Tlen,
                            int S, int split, void* stream) {
  return dispatch<Launch>(dtype, G, D, q, k, v, ctx, o, l, m, B, KVH, G, D,
                          Tlen, S, split, (cudaStream_t)stream);
}
