// The shared-memory tile step of the split-K decode kernels
// (paged_attention.cu, flash_decode.cu): stage up to TILE key/value tokens
// in shared memory as fp32, then advance each warp's fp32 online softmax
// over them.
//
// Layout: a block of WARPS warps; warp w owns query rows w, w + WARPS, ...
// (RPW rows a warp) with m, l and the accumulator in registers, each lane
// holding DPL of the D output columns (column lane + 32 * dd). Scores are
// computed one key token per lane from the K tile padded to D+1 floats a
// row (the lanes hit distinct banks); P.V broadcasts each lane's
// probability with a shuffle. m stays the exact running max of the live
// scores; a row that has seen no live token keeps m = -1e30, l = 0, acc = 0
// (the finite dead-split sentinel: it merges to 0, never NaN).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace decode_tile {

constexpr int WARPS = 4;
constexpr int TILE = 64;          // tokens per shared-memory tile
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Dynamic shared memory of a block: the [rows, D] q tile, one [TILE, D+1]
// K tile and one [TILE, D] V tile, all fp32.
inline size_t smem_bytes(int rows, int D) {
  return sizeof(float) * ((size_t)rows * D + (size_t)TILE * (D + 1) +
                          (size_t)TILE * D);
}

template <int DPL, int RPW>
struct Rows {
  float acc[RPW][DPL], m[RPW], l[RPW];

  __device__ __forceinline__ Rows() {
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      m[i] = NEG_INF;
      l[i] = 0.f;
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) acc[i][dd] = 0.f;
    }
  }

  // Tokens [0, n) of the tile are staged in ks/vs; live(r, t) says whether
  // query row r sees tile token t. Called by every thread of the block.
  template <typename Live>
  __device__ __forceinline__ void step(const float* qs, const float* ks,
                                       const float* vs, int n, int rows,
                                       int D, float sqrt_d, Live live) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int t0 = 0; t0 < n; t0 += 32) {
      const int t = t0 + lane;
      const bool tin = t < n;
      const int nt = min(32, n - t0);
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int r = warp + WARPS * i;
        if (r >= rows) break;   // warp-uniform
        float sc = 0.f;
        if (tin) {
          const float* qr = qs + r * D;
          const float* kr = ks + t * (D + 1);
          for (int d = 0; d < D; ++d) sc = fmaf(qr[d], kr[d], sc);
        }
        sc = sc / sqrt_d;
        const bool ok = tin && live(r, t);
        sc = ok ? sc : NEG_INF;
        const float m_new = fmaxf(m[i], warp_max(sc));
        const float p = ok ? expf(sc - m_new) : 0.f;
        const float corr = expf(m[i] - m_new);
        l[i] = l[i] * corr + warp_sum(p);
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
        const int d = lane + 32 * dd;
        if (d < D) o[row * D + d] = acc[i][dd];
      }
      if (lane == 0) {
        lo[row] = l[i];
        mo[row] = m[i];
      }
    }
  }
};

// Copy the [rows, D] q tile into shared memory as fp32. The first
// __syncthreads of the tile loop publishes it.
template <typename T>
__device__ __forceinline__ void load_q(float* qs, const T* qb, int rows,
                                       int D) {
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) qs[i] = to_f(qb[i]);
}

// Stage tokens [0, n) of a K/V run (token t at kb + t * tok_stride) into
// ks (rows of D+1) and vs as fp32, between two block barriers.
template <typename T>
__device__ __forceinline__ void load_tile(float* ks, float* vs, const T* kb,
                                          const T* vb, int n, int D,
                                          size_t tok_stride) {
  __syncthreads();     // the previous tile's reads of ks/vs are done
  for (int i = threadIdx.x; i < n * D; i += blockDim.x) {
    const int t = i / D, d = i - t * D;
    const size_t off = (size_t)t * tok_stride + d;
    ks[t * (D + 1) + d] = to_f(kb[off]);
    vs[t * D + d] = to_f(vb[off]);
  }
  __syncthreads();
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

// Raise the block's dynamic shared memory limit when it is over 48 KB.
template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace decode_tile
