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
// sequential slot axis becomes a walk inside the block, since blocks run in
// no order and carry nothing between them. The block reads its own
// bt[b, slot] (there is no scalar prefetch on this card) and streams the
// live tokens of its slots through a ring of two shared-memory stages in
// the pool's own type (decode_tile.cuh, shared with flash_decode.cu): a
// stage holds 64 tokens (32 for fp32 at D > 64), so several pages a stage
// at page 16 and 64-token sub-tiles of a 256-token page, and the block's
// shared memory depends on rows and D only, never on the page size. The
// copies of the next stage (the next live pages) are issued before the
// current one is scored, so page walks overlap their loads. Slots that are
// dead, tokens past the context and sub-tiles wholly below the window are
// never read. Each warp runs an fp32 online softmax for its query rows. A
// split with no live page emits m = -1e30, l = 0, o = 0 - a finite
// sentinel, so the merge of an idle slot gives 0 and never
// exp(-inf - -inf) = NaN.
//
// Row tiles. A block holds at most 32 q rows (WARPS warps of at most 8
// rows). A speculative verify pass has G * qpos rows (64 at llama3.2-1b's
// G = 4 and 15 proposals), so the wrapper cuts the rows into even tiles of
// at most 32 and launches once a tile (kernels/paged_attention.py::
// row_tiles); each launch re-reads the block's pages, and row r keeps its
// position ctx - 1 + r % qpos through the tile's row offset.
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

// The live tokens of split s's table slots, page by page, in chunks of at
// most `chunk` tokens (a whole page when pages are no longer than a stage).
struct PageWalk {
  const int* bt;   // bt[b, :]
  int s, K, W, page, chunk, c, w, lo_tok, qpos, ring_width, windowed_slice;
  size_t tok_stride;
  int j = 0, sub = 0, t_end = -1, pid = 0, vpg = 0;

  __device__ __forceinline__ bool next(Chunk& ch) {
    while (j < K) {
      if (t_end < 0) {   // entering table slot s * K + j
        const int slot = s * K + j;
        if (slot >= W) break;
        if (ring_width) {
          const int cur = floordiv(c - 1, page);
          vpg = cur - pymod(cur - slot, ring_width);   // < 0: never written
        } else if (windowed_slice) {
          vpg = max(c - w, 0) / page + slot;
        } else {
          vpg = slot;
        }
        pid = bt[slot];
        const bool live = pid >= 0 && vpg >= 0 &&
                          vpg * page < c + qpos - 1 &&
                          (vpg + 1) * page > lo_tok;
        // tokens of this page any row can see lie below c + qpos - 1
        t_end = live ? min(page, c + qpos - 1 - vpg * page) : 0;
        sub = 0;
      }
      if (sub >= t_end) {
        ++j;
        t_end = -1;
        continue;
      }
      const int base = sub;
      sub += chunk;
      if (w > 0 && vpg * page + base + chunk <= lo_tok) continue;
      ch.src = ((size_t)pid * page + base) * tok_stride;
      ch.tok0 = vpg * page + base;
      ch.n = min(chunk, t_end - base);
      return true;
    }
    return false;
  }
};

// q [B, KVH, rows_total, D]; kp/vp [P, page, KVH, D]; bt [B, W]; ctx, win
// [B]; o [S, B, KVH, rows_total, D]; l, m [S, B, KVH, rows_total]. A block
// takes the `rows` q rows from row0 (the wrapper launches one call a row
// tile when G * qpos exceeds what one block holds); row r of the q tile sits
// at position ctx - 1 + r % qpos, r counted from row 0 of the whole q, so a
// tile that starts mid-group keeps its rows' positions. Split s owns table
// slots [s*K, s*K + K); slots at or past W are the tail split's padding and
// are dead.
template <typename T, int DPL, int RPW>
__global__ void __launch_bounds__(WARPS * 32)
paged_partials_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                      const T* __restrict__ vp, const int* __restrict__ bt,
                      const int* __restrict__ ctx, const int* __restrict__ win,
                      float* __restrict__ o, float* __restrict__ l,
                      float* __restrict__ m, int B, int KVH, int rows,
                      int rows_total, int row0, int D, int page, int W, int K,
                      int ring_width, int windowed_slice, int qpos) {
  const int h = blockIdx.x % KVH;
  const int b = (blockIdx.x / KVH) % B;
  const int s = blockIdx.x / (KVH * B);

  extern __shared__ __align__(16) uint8_t smem[];
  float* qs = reinterpret_cast<float*>(smem);   // [rows, D]
  load_q(qs, q + ((size_t)(b * KVH + h) * rows_total + row0) * D, rows, D);

  const int c = ctx[b], w = win[b];
  const size_t tok_stride = (size_t)KVH * D;
  constexpr int TOK = stage_tokens((int)sizeof(T), DPL);
  const int chunk = min(page, TOK);
  PageWalk walk{bt + (size_t)b * W, s, K, W, page, chunk, c, w,
                w > 0 ? c - w : 0, qpos, ring_width, windowed_slice,
                tok_stride};
  Rows<DPL, RPW> acc;
  stream<T, DPL, RPW>(acc, qs, smem + sizeof(float) * rows * D, walk,
                      kp + (size_t)h * D, vp + (size_t)h * D, tok_stride,
                      chunk, rows, D, sqrtf((float)D), [&](int r, int tok) {
                        const int hi = c + (row0 + r) % qpos;
                        return tok < hi && (w <= 0 || tok >= hi - w);
                      });
  acc.store(o, l, m, (((size_t)s * B + b) * KVH + h) * rows_total + row0,
            rows, D);
}

struct Launch {
  template <typename T, int DPL, int RPW>
  static int run(const void* q, const void* k, const void* v, const void* bt,
                 const void* ctx, const void* win, void* o, void* l, void* m,
                 int B, int KVH, int rows, int rows_total, int row0, int D,
                 int page, int W, int S, int K, int ring_width,
                 int windowed_slice, int qpos, cudaStream_t stream) {
    const size_t smem = smem_bytes(rows, D, (int)sizeof(T), DPL);
    auto kern = paged_partials_kernel<T, DPL, RPW>;
    cudaError_t e = allow_smem(kern, smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<S * B * KVH, WARPS * 32, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const int*)bt,
        (const int*)ctx, (const int*)win, (float*)o, (float*)l, (float*)m, B,
        KVH, rows, rows_total, row0, D, page, W, K, ring_width, windowed_slice,
        qpos);
    return (int)cudaGetLastError();
  }
};

}  // namespace

// Dynamic shared memory one block needs at most (either input type): the
// [rows, D] fp32 q tile and the ring of K / V stages, whatever the page
// size.
extern "C" long long paged_attention_smem(int rows, int D) {
  return (long long)smem_bytes_max(rows, D);
}

// dtype: 0 = float32, 1 = bfloat16 (q, K and V pages share it). Computes
// rows [row0, row0 + rows) of q's rows_total rows. The caller guarantees
// D <= 128 with D * sizeof(dtype) a multiple of 16, rows <= 32,
// row0 + rows <= rows_total, 16-byte aligned pools and contiguous q and
// int32 bt/ctx/win. Returns cudaGetLastError() after the launch.
extern "C" int paged_attention_partials(
    int dtype, const void* q, const void* k, const void* v, const void* bt,
    const void* ctx, const void* win, void* o, void* l, void* m, int B,
    int KVH, int rows, int rows_total, int row0, int D, int page, int W,
    int S, int K, int ring_width, int windowed_slice, int qpos,
    void* stream) {
  return dispatch<Launch>(dtype, rows, D, q, k, v, bt, ctx, win, o, l, m, B,
                          KVH, rows, rows_total, row0, D, page, W, S, K,
                          ring_width, windowed_slice, qpos,
                          (cudaStream_t)stream);
}
