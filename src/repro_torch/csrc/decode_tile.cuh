// The pipeline the split-K decode kernels share (paged_attention.cu,
// flash_decode.cu): stream a block's live key/value tokens through a ring of
// shared-memory stages with asynchronous copies, and advance each warp's
// fp32 online softmax over every stage that has landed.
//
// Staging. A stage holds TOK tokens of K and of V in their own type (bf16
// stays bf16: half the bytes of fp32, so a stage of the same size holds
// twice the tokens), one row per token with a pitch of D * sizeof(T) + 16
// bytes so that the 16-byte reads of the score loop hit distinct banks.
// Rows arrive by 16-byte cp.async.cg, every thread issuing its share of a
// stage's copies at once. The ring has STAGES = 2 stages: while stage i is
// scored, the copies of stage i + 1 are in flight, and one block barrier a
// stage (not two a tile) both publishes stage i and frees the slot of stage
// i - 1 for the next copies. (Three stages measured slower on the H100:
// the third stage's shared memory costs blocks per SM, and more resident
// blocks keep more copies in flight than a deeper ring does.)
//
// What fills a stage is a walk over the block's live tokens in chunks of at
// most `chunk` tokens: the split's contiguous run for flash_decode, the live
// pages of the block table for paged_attention (several pages a stage when
// pages are shorter than a stage, 64-token sub-tiles of a longer page).
// A stage records, per chunk, the position of its first token and how many
// of its tokens were copied; the score loop skips the positions the copies
// did not reach, and P.V meets them with probability 0 (the V stages are
// zeroed once, so their rows are finite).
//
// Compute. A block of WARPS warps; warp w owns query rows w, w + WARPS, ...
// (RPW rows a warp) with m, l and the accumulator in registers, each lane
// holding DPL of the D output columns (Rows::col: pairs of neighbours, so
// P.V reads V 4 or 8 bytes at a time). Scores are
// computed one key token per lane (fp32 products of the staged row, read
// 16 bytes at a time); P.V broadcasts each lane's probability with a
// shuffle. m stays the exact running max of the live scores; a row that has
// seen no live token keeps m = -1e30, l = 0, acc = 0 (the finite dead-split
// sentinel: it merges to 0, never NaN).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_limit.cuh"

namespace decode_tile {

constexpr int WARPS = 4;
constexpr int STAGES = 2;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// Tokens a stage holds: 64, or 32 for fp32 rows of more than 64 values, so a
// K or V stage stays near 16 KB whatever the type.
__host__ __device__ constexpr int stage_tokens(int esize, int dpl) {
  return (esize == 4 && dpl > 2) ? 32 : 64;
}
__host__ __device__ inline int pitch_bytes(int D, int esize) {
  return D * esize + 16;
}

// Dynamic shared memory of a block: the [rows, D] fp32 q tile, STAGES K and
// V stages of `tok` rows, and each stage's chunk record (1 + 2 * tok ints).
inline size_t smem_bytes(int rows, int D, int esize, int dpl) {
  const int tok = stage_tokens(esize, dpl);
  return sizeof(float) * (size_t)rows * D +
         (size_t)STAGES * 2 * tok * pitch_bytes(D, esize) +
         sizeof(int) * (size_t)STAGES * (1 + 2 * tok);
}
// The most a block needs at (rows, D) for either input type.
inline size_t smem_bytes_max(int rows, int D) {
  const int dpl = D <= 32 ? 1 : D <= 64 ? 2 : 4;
  const size_t f32 = smem_bytes(rows, D, 4, dpl);
  const size_t bf16 = smem_bytes(rows, D, 2, dpl);
  return f32 > bf16 ? f32 : bf16;
}

__device__ __forceinline__ void cp16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(smem)),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// two neighbouring values (v[0], v[1]) as fp32, one load
__device__ __forceinline__ float2 to_f2(const float* v) {
  return *reinterpret_cast<const float2*>(v);
}
__device__ __forceinline__ float2 to_f2(const __nv_bfloat16* v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(v));
}
// e^x as 2^(x log2 e), one MUFU op
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// q . k for one staged key row, 16 bytes of k at a time (two partial sums)
__device__ __forceinline__ float dot(const float* q, const uint8_t* k, int D,
                                     const float*) {
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const float4* k4 = reinterpret_cast<const float4*>(k);
  float a = 0.f, b = 0.f;
  for (int i = 0; i < D / 4; ++i) {
    const float4 x = q4[i], y = k4[i];
    a = fmaf(x.x, y.x, a);
    b = fmaf(x.y, y.y, b);
    a = fmaf(x.z, y.z, a);
    b = fmaf(x.w, y.w, b);
  }
  return a + b;
}
__device__ __forceinline__ float dot(const float* q, const uint8_t* k, int D,
                                     const __nv_bfloat16*) {
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const uint4* k8 = reinterpret_cast<const uint4*>(k);
  float a = 0.f, b = 0.f;
  for (int i = 0; i < D / 8; ++i) {
    const uint4 raw = k8[i];
    const float4 x0 = q4[2 * i], x1 = q4[2 * i + 1];
    const float2 y0 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 y1 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    const float2 y2 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.z));
    const float2 y3 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.w));
    a = fmaf(x0.x, y0.x, a);
    b = fmaf(x0.y, y0.y, b);
    a = fmaf(x0.z, y1.x, a);
    b = fmaf(x0.w, y1.y, b);
    a = fmaf(x1.x, y2.x, a);
    b = fmaf(x1.y, y2.y, b);
    a = fmaf(x1.z, y3.x, a);
    b = fmaf(x1.w, y3.y, b);
  }
  return a + b;
}

// A run of at most `chunk` live tokens: its first token at element offset
// src of k / v, at position tok0, n tokens long.
struct Chunk {
  size_t src;
  int tok0, n;
};

template <int DPL, int RPW>
struct Rows {
  float acc[RPW][DPL], m[RPW], l[RPW];

  // the output column of a lane's value dd: lane at D <= 32, else the
  // neighbours 2 lane, 2 lane + 1 of each 64 columns
  __device__ __forceinline__ static int col(int lane, int dd) {
    return DPL == 1 ? lane : 64 * (dd >> 1) + 2 * lane + (dd & 1);
  }

  __device__ __forceinline__ Rows() {
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      m[i] = NEG_INF;
      l[i] = 0.f;
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) acc[i][dd] = 0.f;
    }
  }

  // One landed stage: positions [0, mt[0] * chunk) of ks / vs, where
  // position c * chunk + tt holds token mt[1 + c] + tt if tt < mt[1 + TOK
  // + c]. live(r, tok) says whether query row r sees token tok. Called by
  // every thread of the block.
  template <typename T, int TOK, typename Live>
  __device__ __forceinline__ void step(const float* qs, const uint8_t* ks,
                                       const uint8_t* vs, int pitch,
                                       const int* mt, int chunk, int rows,
                                       int D, float sqrt_d, Live live) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int npos = mt[0] * chunk;
    const float inv_sqrt_d = 1.f / sqrt_d;
    for (int t0 = 0; t0 < npos; t0 += 32) {
      const int t = t0 + lane;
      bool tin = false;
      int tok = 0;
      if (t < npos) {
        const int c = t / chunk, tt = t - c * chunk;
        tin = tt < mt[1 + TOK + c];
        tok = mt[1 + c] + tt;
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int r = warp + WARPS * i;
        if (r >= rows) break;   // warp-uniform
        float sc = 0.f;
        if (tin) sc = dot(qs + r * D, ks + t * pitch, D, (const T*)nullptr);
        sc *= inv_sqrt_d;
        const bool ok = tin && live(r, tok);
        sc = ok ? sc : NEG_INF;
        const float m_new = fmaxf(m[i], warp_max(sc));
        const float p = ok ? exp_fast(sc - m_new) : 0.f;
        const float corr = exp_fast(m[i] - m_new);
        l[i] = l[i] * corr + warp_sum(p);
        // all 32 positions of the pass, unrolled: a position the stage did
        // not reach has p = 0 and a finite V row (see stream)
        float odd[DPL];
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) {
          acc[i][dd] *= corr;
          odd[dd] = 0.f;
        }
#pragma unroll
        for (int jj = 0; jj < 32; ++jj) {
          const float pj = __shfl_sync(FULL, p, jj);
          const T* vr = reinterpret_cast<const T*>(vs + (t0 + jj) * pitch);
          auto fma_row = [&](float (&a)[DPL]) {
            if constexpr (DPL == 1) {
              if (lane < D) a[0] = fmaf(pj, to_f(vr[lane]), a[0]);
            } else {
#pragma unroll
              for (int dd = 0; dd < DPL; dd += 2) {
                const int d = col(lane, dd);   // D is even: d, d + 1 < D
                if (d < D) {
                  const float2 v = to_f2(vr + d);
                  a[dd] = fmaf(pj, v.x, a[dd]);
                  a[dd + 1] = fmaf(pj, v.y, a[dd + 1]);
                }
              }
            }
          };
          if (jj & 1)
            fma_row(odd);
          else
            fma_row(acc[i]);
        }
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) acc[i][dd] += odd[dd];
        m[i] = m_new;
      }
    }
  }

  // Row r of this block's partials is written at out_row0 + r.
  __device__ __forceinline__ void store(float* o, float* lo, float* mo,
                                        size_t out_row0, int rows, int D) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + WARPS * i;
      if (r >= rows) break;
      const size_t row = out_row0 + r;
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) {
        const int d = col(lane, dd);
        if (d < D) o[row * D + d] = acc[i][dd];
      }
      if (lane == 0) {
        lo[row] = l[i];
        mo[row] = m[i];
      }
    }
  }
};

// Copy the [rows, D] q tile into shared memory as fp32. The first barrier
// of the stage loop publishes it.
template <typename T>
__device__ __forceinline__ void load_q(float* qs, const T* qb, int rows,
                                       int D) {
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) qs[i] = to_f(qb[i]);
}

// Stream every chunk `walk` yields (walk.next(Chunk&) -> bool, the same
// sequence on every thread) through the ring at `ring` and fold each landed
// stage into acc. k / v hold token t of a chunk at src + t * tok_stride.
template <typename T, int DPL, int RPW, typename Walk, typename Live>
__device__ __forceinline__ void stream(Rows<DPL, RPW>& acc, const float* qs,
                                       uint8_t* ring, Walk& walk,
                                       const T* __restrict__ k,
                                       const T* __restrict__ v,
                                       size_t tok_stride, int chunk, int rows,
                                       int D, float sqrt_d, Live live) {
  constexpr int TOK = stage_tokens((int)sizeof(T), DPL);
  constexpr int MW = 1 + 2 * TOK;   // ints of a stage's chunk record
  const int pitch = pitch_bytes(D, (int)sizeof(T));
  const int cpr = D * (int)sizeof(T) / 16;   // 16-byte copies a row
  const int cps = TOK / chunk;               // chunks a stage
  const size_t stage = 2 * (size_t)TOK * pitch;
  int* meta = reinterpret_cast<int*>(ring + STAGES * stage);

  auto fill = [&](int slot) {
    uint8_t* kd = ring + slot * stage;
    uint8_t* vd = kd + (size_t)TOK * pitch;
    int* mt = meta + slot * MW;
    int c = 0;
    Chunk ch;
    while (c < cps && walk.next(ch)) {
      uint8_t* kr = kd + (size_t)c * chunk * pitch;
      uint8_t* vr = vd + (size_t)c * chunk * pitch;
      for (int i = threadIdx.x; i < ch.n * cpr; i += blockDim.x) {
        const int t = i / cpr, col = 16 * (i - t * cpr);
        const size_t so = ch.src + (size_t)t * tok_stride;
        cp16(kr + t * pitch + col,
             reinterpret_cast<const uint8_t*>(k + so) + col);
        cp16(vr + t * pitch + col,
             reinterpret_cast<const uint8_t*>(v + so) + col);
      }
      if (threadIdx.x == 0) {
        mt[1 + c] = ch.tok0;
        mt[1 + TOK + c] = ch.n;
      }
      ++c;
    }
    if (threadIdx.x == 0) mt[0] = c;
  };

  // V rows a stage does not reach are read by P.V with p = 0: zero the V
  // stages once, so such a row holds zeros or a token of an earlier stage
  for (int s = 0; s < STAGES; ++s) {
    uint4* vz =
        reinterpret_cast<uint4*>(ring + s * stage + (size_t)TOK * pitch);
    for (int i = threadIdx.x; i < TOK * pitch / 16; i += blockDim.x)
      vz[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();   // before any copy lands in the same bytes
  for (int s = 0; s < STAGES - 1; ++s) {
    fill(s);
    cp_commit();
  }
  for (int i = 0;; ++i) {
    cp_wait<STAGES - 2>();   // this thread's copies of stage i landed
    __syncthreads();         // everyone's did; stage i - 1 is consumed
    const int slot = i % STAGES;
    const int* mt = meta + slot * MW;
    if (mt[0] == 0) break;   // the walk ended (uniform)
    fill((i + STAGES - 1) % STAGES);
    cp_commit();
    const uint8_t* ks = ring + slot * stage;
    acc.template step<T, TOK>(qs, ks, ks + (size_t)TOK * pitch, pitch, mt,
                              chunk, rows, D, sqrt_d, live);
  }
}

// Instantiate kernel_launch<T, DPL, RPW>(args...) for the runtime (rows, D)
// of a call: RPW = ceil(rows / WARPS) in {1, 2, 4, 8}, DPL = ceil(D / 32) in
// {1, 2, 4}. Launch is a functor template with a static run<T, DPL, RPW>.
template <typename Launch, typename T, int DPL, typename... A>
int by_rows(int rows, A... args) {
  const int rpw = (rows + WARPS - 1) / WARPS;
  if (rpw <= 1) return Launch::template run<T, DPL, 1>(args...);
  if (rpw <= 2) return Launch::template run<T, DPL, 2>(args...);
  if (rpw <= 4) return Launch::template run<T, DPL, 4>(args...);
  return Launch::template run<T, DPL, 8>(args...);
}

template <typename Launch, typename... A>
int dispatch(int dtype, int rows, int D, A... args) {
  const int dpl = (D + 31) / 32;
  if (dtype == 1) {
    if (dpl <= 1) return by_rows<Launch, __nv_bfloat16, 1>(rows, args...);
    if (dpl <= 2) return by_rows<Launch, __nv_bfloat16, 2>(rows, args...);
    return by_rows<Launch, __nv_bfloat16, 4>(rows, args...);
  }
  if (dpl <= 1) return by_rows<Launch, float, 1>(rows, args...);
  if (dpl <= 2) return by_rows<Launch, float, 2>(rows, args...);
  return by_rows<Launch, float, 4>(rows, args...);
}

}  // namespace decode_tile
