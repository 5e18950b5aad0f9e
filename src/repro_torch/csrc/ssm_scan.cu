// Mamba2 chunked gated-linear-attention scan for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel repro/kernels/ssm_scan.py (_kernel, called
// from ssm_chunk_scan). It computes models/ssm.py::chunked_gla with
// normalize=False for one (batch row, head): for each chunk of c <= 128
// tokens, with bcum = cumsum(log_a) (inclusive), btot = bcum[-1],
//   W_ij = exp(clip(bcum_i - bcum_j + log_g_j, -1e30, 60)) for i >= j, else 0
//   y    = (q k^T . W) v + exp(bcum) . (q C)
//   sc_j = exp(clip(btot - bcum_j + log_g_j, -1e30, 60))
//   C   <- C exp(btot) + (k . sc)^T v,   n <- n exp(btot) + sum_j k_j sc_j
// The TPU kernel returns only C; this one also carries n (Mamba2 never reads
// it, but the serving state holds it), so the state equals the JAX state
// leaf for leaf. q and k are read through explicit element strides, so the
// Mamba2 caller passes its head-broadcast (stride-0) views without copying
// them to every head. Masked positions arrive as log_a = 0, log_g = -1e30;
// the clip sends them to exp(-1e30) = 0, never to NaN.
//
// Two kernels, picked by the chunk:
//
// * ssm_chunk_kernel (chunk > 1: prefill and chunked prefill). What bounds
//   it is the arithmetic: four small products a chunk (q k^T and S v on the
//   causal half, q C and k^T v in full). They run on the tensor cores as
//   mma.sync.m16n8k8 TF32 products of split operands (tf32_mma.cuh): an fp32
//   operand is hi + lo, and a product takes three TF32 products, or two
//   where one side is a bf16 value (exact in TF32); q k^T of bf16 inputs
//   is one bf16 mma.m16n8k16 (exact products, fp32 accumulation; faster
//   on the H100 at zamba2's prefill shapes than one TF32 product a k8
//   step). One block per (b, h, slice of PD columns of P)
//   runs the chunk loop, with the [N, PD] state in shared memory for the
//   whole sequence (read from device memory once and written once), and 8
//   warps, each owning 16 chunk rows (row_block). A chunk:
//     1. every warp takes y_w = exp(bcum) . (q_w C) from the old C;
//     2. after a barrier, each warp adds, for each 16-key block up to its
//        diagonal, S = q_w k^T in registers, weighted by W in registers and
//        fed straight from the score fragment into y_w += S v (the mma's k
//        order permuted, A column c <- token 2c, c + 4 <- token 2c + 1,
//        with v's rows read to match, so no shuffle is needed): no [c, c]
//        tile touches shared memory;
//     3. the state update C <- C exp(btot) + (k sc)^T v (same permuted k
//        order), in 16 x 32 tiles of C, each owned by one warp, n alongside
//        from the same k sc values. The tiles go to the warps with the
//        fewest key blocks, so the causal triangle's short rows take them.
//   The next chunk's q, k, v, log_a and log_g arrive by cp.async into a
//   second stage in their own type while the current chunk computes
//   (16-byte copies where the layout allows them, as Mamba2's does, else
//   value by value; one stage where two do not fit). Rows are padded by 16
//   bytes so the fragment loads hit distinct banks. At N = P = 64, PD = 64:
//   ~226 KB fp32, ~130 KB bf16, one block an SM.
// * ssm_step_kernel (chunk == 1: the decode step, S = 1, or a sequence whose
//   length has no larger divisor). What bounds it is bytes: per token the
//   [N, P] fp32 state is read and written once and the arithmetic is one
//   rank-1 update and one matrix-vector product. Per token, with a =
//   exp(log_a), g = exp(clip(log_g)):
//     y = a (q C) + g (q . k) v,   C <- a C + g k v^T,   n <- a n + g k
//   (y is q C' up to rounding, in the order the chunk formula takes it).
//   128 threads a (b, h) stream C in 16-byte loads, each thread holding its
//   rows of one group of 4 columns in registers and writing C' straight
//   back; q C is reduced over the rows through a small [rows a pass, P]
//   buffer. No [N, P] state is staged in shared memory. q and k, shared by
//   the heads, come from L2 after the first head's block has read them.
//
// SSM_ABLATE (a bit mask, 0 unless the compiler is given -DSSM_ABLATE=m)
// builds timing variants of the chunk kernel whose results are wrong by
// design; chip_smoke.py --k4-ablation times them to show where its time
// goes: 1 drops the score / W / S v loop, 2 drops W's exp (the causal mask
// stays), 4 drops the state update, 8 takes bf16 q k^T as one TF32 product
// (mma.m16n8k8) in place of bf16 mma.m16n8k16 (results stay right).
#ifndef SSM_ABLATE
#define SSM_ABLATE 0
#endif
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_limit.cuh"
#include "tf32_mma.cuh"

namespace {

using namespace tf32mma;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CHUNK = 16 * WARPS;  // 16 chunk rows a warp
constexpr int STEP_THREADS = 128;
constexpr int ROWS = 8;            // state rows a step thread loads at once
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SMEM = 232448;

struct Strides {                   // element strides of q, k, v: (b, s, h, d)
  long long q[4], k[4], v[4];
};
struct Copy16 {                    // rows staged by 16-byte copies, else
  bool q, k, v;                    // value by value
};

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Byte offsets in the chunk kernel's dynamic shared memory. A stage holds
// rows = round16(chunk) rows of q and k (pitch round16(N) values + 16 B) and
// of this block's PD columns of v (PD values + 16 B), in the input's type,
// then log_a and log_g; rows and columns past the data stay zero.
struct Layout {
  int rows, n16, qp, vp, cp, q, k, v, la, lg, stage, cs, bc, lgs, sc, ns,
      total;
  __host__ __device__ Layout(int N, int PD, int chunk, int es, int stages) {
    rows = round_up(chunk, 16);
    n16 = round_up(N, 16);
    qp = n16 * es + 16;
    vp = PD * es + 16;
    cp = PD + 8;                     // floats a state row
    q = 0;
    k = rows * qp;
    v = 2 * rows * qp;
    la = v + rows * vp;
    lg = la + 4 * rows;
    stage = lg + 4 * rows;
    cs = stages * stage;
    bc = cs + 4 * n16 * cp;
    lgs = bc + 4 * rows;
    sc = lgs + 4 * rows;
    ns = sc + 4 * rows;
    total = ns + 4 * n16;
  }
};

// Stages a chunk takes: two (the next chunk's copies overlap this one's
// products) where they fit, else one.
int chunk_stages(int N, int PD, int chunk, int es) {
  return Layout(N, PD, chunk, es, 2).total <= MAX_SMEM ? 2 : 1;
}

// The 16-row block of the chunk warp w owns. Block r has r + 1 key blocks
// to its diagonal; warps w and w + 4 share an SM sub-partition, so they
// take blocks w and 7 - w.
__device__ __forceinline__ int row_block(int w) {
  return w < WARPS / 2 ? w : 3 * WARPS / 2 - 1 - w;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float clip_exp(float x) {
  return expf(fminf(fmaxf(x, NEG_INF), 60.f));
}
// the same as 2^(x log2 e), one MUFU op (the weights of the chunk kernel,
// ~c^2 / 2 a chunk)
__device__ __forceinline__ float clip_exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;"
      : "=f"(y)
      : "f"(fminf(fmaxf(x, NEG_INF), 60.f) * 1.4426950408889634f));
  return y;
}

// value (r, c) of a staged tile of T with a pitch of `pitch` bytes, as fp32
template <typename T>
__device__ __forceinline__ float el(const uint8_t* base, int pitch, int r,
                                    int c) {
  return to_f(*reinterpret_cast<const T*>(base + r * pitch +
                                          c * (int)sizeof(T)));
}

// ---- asynchronous copies ---------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(s)),
               "l"(g) : "memory");
}
__device__ __forceinline__ void cp_async4(void* s, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(s)),
               "l"(g) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// rows x nel values of T (row stride srow, value stride sd, in elements)
// into shared rows of `pitch` bytes, by 16-byte copies (vec16) or value by
// value through registers (any strides).
template <typename T>
__device__ __forceinline__ void stage_rows(uint8_t* dst, int pitch,
                                           const T* src, long long srow,
                                           long long sd, int nel, int rows,
                                           bool vec16) {
  if (vec16) {
    const int per_row = nel * (int)sizeof(T) / 16;
    for (int idx = threadIdx.x; idx < rows * per_row; idx += THREADS) {
      const int r = idx / per_row, u = idx - r * per_row;
      cp_async16(dst + r * pitch + 16 * u,
                 reinterpret_cast<const uint8_t*>(src + r * srow) + 16 * u);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * nel; idx += THREADS) {
      const int r = idx / nel, d = idx - r * nel;
      reinterpret_cast<T*>(dst + r * pitch)[d] = src[r * srow + d * sd];
    }
  }
}

// ---- tensor-core products --------------------------------------------------

// d[0..3] += a.b for bf16 A (16 x 16) and B (16 x 8) fragments, two values
// a register: exact products, fp32 accumulation
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- the chunk kernel ------------------------------------------------------
//
// Fragments (mma.sync m16n8k8, per warp): lane = 4 g8 + c4; A value i at row
// g8 + 8 (i & 1), k column c4 + 4 (i >> 1); B values at k row c4 and c4 + 4,
// column g8; the accumulator's value e at row g8 + 8 ((e >> 1) & 1), column
// 2 c4 + (e & 1).

template <typename T, int PD, bool CACHEQ>
__global__ void __launch_bounds__(THREADS,
                                  (sizeof(T) == 2 && PD == 32) ? 2 : 1)
ssm_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ la,
                 const float* __restrict__ lg, const float* __restrict__ c0,
                 const float* __restrict__ n0, float* __restrict__ y,
                 float* __restrict__ c_out, float* __restrict__ n_out,
                 Strides st, Copy16 wd, int S, int H, int N, int P,
                 int chunk, int stages) {
  constexpr bool BF = sizeof(T) == 2;   // q, k, v exact in TF32
  constexpr Split XIN = BF ? EXACT : RAW;
  constexpr int PT = PD / 8;            // 8-column tiles of the slice
  constexpr int ES = (int)sizeof(T);
  extern __shared__ __align__(16) uint8_t sm[];
  const Layout L(N, PD, chunk, ES, stages);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, c4 = lane & 3;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int p0 = blockIdx.y * PD, pw = min(PD, P - p0);
  float* Cs = reinterpret_cast<float*>(sm + L.cs);
  float* bc = reinterpret_cast<float*>(sm + L.bc);
  float* lgs = reinterpret_cast<float*>(sm + L.lgs);
  float* sc = reinterpret_cast<float*>(sm + L.sc);
  float* ns = reinterpret_cast<float*>(sm + L.ns);

  for (int i = tid; i < L.total / 16; i += THREADS)
    reinterpret_cast<uint4*>(sm)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  for (int idx = tid; idx < N * pw; idx += THREADS) {
    const int n = idx / pw, p = idx - n * pw;
    Cs[n * L.cp + p] = c0 ? c0[((size_t)bh * N + n) * P + p0 + p] : 0.f;
  }
  for (int d = tid; d < N; d += THREADS)
    ns[d] = n0 ? n0[(size_t)bh * N + d] : 0.f;

  const T* qb = q + b * st.q[0] + h * st.q[2];
  const T* kb = k + b * st.k[0] + h * st.k[2];
  const T* vb = v + b * st.v[0] + h * st.v[2] + p0 * st.v[3];
  const float* lab = la + (size_t)b * S * H + h;
  const float* lgb = lg + (size_t)b * S * H + h;
  const int n_chunks = S / chunk;

  auto issue = [&](int ci) {
    uint8_t* stg = sm + (ci & (stages - 1)) * L.stage;
    const long long t0 = (long long)ci * chunk;
    stage_rows(stg + L.q, L.qp, qb + t0 * st.q[1], st.q[1], st.q[3], N,
               chunk, wd.q);
    stage_rows(stg + L.k, L.qp, kb + t0 * st.k[1], st.k[1], st.k[3], N,
               chunk, wd.k);
    stage_rows(stg + L.v, L.vp, vb + t0 * st.v[1], st.v[1], st.v[3], pw,
               chunk, wd.v);
    for (int i = tid; i < 2 * chunk; i += THREADS) {
      const int r = i < chunk ? i : i - chunk;
      const float* src = (i < chunk ? lab : lgb) + (t0 + r) * H;
      cp_async4(stg + (i < chunk ? L.la : L.lg) + 4 * r, src);
    }
    cp_commit();
  };

  const int nk = (N + 7) / 8;                     // 8-wide steps over N
  const int nkt = (chunk + 7) / 8;                // 8-token steps
  const int units = (L.n16 / 16) * (PD / 32);     // 16 x 32 tiles of C

  issue(0);
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * chunk;
    cp_wait_all();
    __syncthreads();   // chunk ci landed; every warp is done with ci - 1
    if (stages == 2 && ci + 1 < n_chunks) issue(ci + 1);
    const uint8_t* stg = sm + (ci & (stages - 1)) * L.stage;
    const uint8_t* qs = stg + L.q;
    const uint8_t* kst = stg + L.k;
    const uint8_t* vs = stg + L.v;

    if (warp == 0) {   // inclusive cumsum of log_a: 4 entries a lane
      const float* las = reinterpret_cast<const float*>(stg + L.la);
      const float* lgst = reinterpret_cast<const float*>(stg + L.lg);
      float loc[MAX_CHUNK / 32], s = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_CHUNK / 32; ++r) {
        const int i = lane * (MAX_CHUNK / 32) + r;
        s += i < chunk ? las[i] : 0.f;
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
        if (i < L.rows) {
          bc[i] = i < chunk ? excl + loc[r] : 0.f;
          lgs[i] = i < chunk ? lgst[i] : NEG_INF;
        }
      }
      __syncwarp();
      const float btot = bc[chunk - 1];
      for (int i = lane; i < L.rows; i += 32)
        sc[i] = i < chunk ? clip_exp_fast(btot - bc[i] + lgs[i]) : 0.f;
    }
    __syncthreads();

    // ---- q_w C of this warp's 16 rows, then y ----
    const int rblk = row_block(warp);
    const bool has_rows = 16 * rblk < chunk;
    const int ra = 16 * rblk + g8, rb = ra + 8;
    float acc[4 * PT];
#pragma unroll
    for (int i = 0; i < 4 * PT; ++i) acc[i] = 0.f;
    // q_w's TF32 A fragments, kept in registers where they serve q k^T too
    // (fp32 inputs, N <= 64), else read where used
    constexpr bool KEEPQ = CACHEQ && !BF;
    FragA<XIN> qc[KEEPQ ? 8 : 1];
    auto qfrag = [&](int ks, FragA<XIN>& a) {
      const int c = 8 * ks + c4;
      a.set(el<T>(qs, L.qp, ra, c), el<T>(qs, L.qp, rb, c),
            el<T>(qs, L.qp, ra, c + 4), el<T>(qs, L.qp, rb, c + 4));
    };
    // body(ks, A) over the k-steps of N with q_w's A fragment
    auto for_q = [&](auto&& body) {
      if constexpr (KEEPQ) {
#pragma unroll
        for (int ks = 0; ks < 8; ++ks)
          if (ks < nk) body(ks, qc[ks]);
      } else {
        for (int ks = 0; ks < nk; ++ks) {
          FragA<XIN> a;
          qfrag(ks, a);
          body(ks, a);
        }
      }
    };
    // bf16 inputs: q k^T as bf16 mma.m16n8k16 (exact products, fp32
    // accumulation), q_w's A fragment as pairs of values, 32 bits a load
    const int nk16 = (N + 15) / 16;
    uint32_t q16[BF && CACHEQ ? 4 : 1][4];
    auto qfrag16 = [&](int k16, uint32_t (&a)[4]) {
      const uint32_t* ra_w =
          reinterpret_cast<const uint32_t*>(qs + ra * L.qp) + 8 * k16 + c4;
      const uint32_t* rb_w =
          reinterpret_cast<const uint32_t*>(qs + rb * L.qp) + 8 * k16 + c4;
      a[0] = ra_w[0];
      a[1] = rb_w[0];
      a[2] = ra_w[4];
      a[3] = rb_w[4];
    };
    auto for_q16 = [&](auto&& body) {
      if constexpr (CACHEQ && BF) {
#pragma unroll
        for (int k16 = 0; k16 < 4; ++k16)
          if (k16 < nk16) body(k16, q16[k16]);
      } else {
        for (int k16 = 0; k16 < nk16; ++k16) {
          uint32_t a[4];
          qfrag16(k16, a);
          body(k16, a);
        }
      }
    };
    if (has_rows) {
      if constexpr (KEEPQ) {
#pragma unroll
        for (int ks = 0; ks < 8; ++ks)
          if (ks < nk) qfrag(ks, qc[ks]);
      }
      if constexpr (CACHEQ && BF) {
#pragma unroll
        for (int k16 = 0; k16 < 4; ++k16)
          if (k16 < nk16) qfrag16(k16, q16[k16]);
      }
      // exp(bcum) . (q_w C)
      for_q([&](int ks, const FragA<XIN>& a) {
        const float* c_lo = Cs + (8 * ks + c4) * L.cp + g8;
#pragma unroll
        for (int pt = 0; pt < PT; ++pt)
          mma_acc<XIN, RAW>(&acc[4 * pt], a, c_lo[8 * pt],
                             c_lo[4 * L.cp + 8 * pt]);
      });
      const float ea = expf(bc[ra]), eb = expf(bc[rb]);
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) {
        acc[4 * pt] *= ea;
        acc[4 * pt + 1] *= ea;
        acc[4 * pt + 2] *= eb;
        acc[4 * pt + 3] *= eb;
      }
    }
    __syncthreads();   // every read of the old C is done

    if (has_rows) {
      // (q_w k^T . W) v, 32 keys at a time (four independent 8-key tiles
      // of scores) up to the diagonal
      const int last = 16 * rblk + 15;
      const float bra = bc[ra], brb = bc[rb];
      for (int k0 = 0; k0 <= ((SSM_ABLATE & 1) ? -1 : 16 * rblk); k0 += 32) {
        const int nj = min(4, (last - k0) / 8 + 1);   // 2 or 4 live tiles
        float s[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) s[i] = 0.f;
        if constexpr (BF && !(SSM_ABLATE & 8)) {
          for_q16([&](int k16, const uint32_t (&a)[4]) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (j >= nj) break;
              const uint32_t* kr = reinterpret_cast<const uint32_t*>(
                  kst + (k0 + 8 * j + g8) * L.qp) + 8 * k16 + c4;
              mma_bf16(&s[4 * j], a, kr[0], kr[4]);
            }
          });
        } else {
          for_q([&](int ks, const FragA<XIN>& a) {
            const int c = 8 * ks + c4;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (j >= nj) break;
              const int key = k0 + 8 * j + g8;
              mma_acc<XIN, XIN>(&s[4 * j], a, el<T>(kst, L.qp, key, c),
                              el<T>(kst, L.qp, key, c + 4));
            }
          });
        }
        // W on the score fragment: value 4 j + 2 hh + x sits at row
        // (ra, rb)[hh], key k0 + 8 j + 2 c4 + x
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j >= nj) break;
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int col = k0 + 8 * j + 2 * c4 + x;
            const float bj = bc[col], lj = lgs[col];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int e = 4 * j + 2 * hh + x;
              const int row = hh ? rb : ra;
              s[e] = !(col <= row && col < chunk) ? 0.f
                     : (SSM_ABLATE & 2)
                         ? s[e]
                         : s[e] * clip_exp_fast((hh ? brb : bra) - bj + lj);
            }
          }
        }
#pragma unroll
        for (int kt = 0; kt < 4; ++kt) {
          if (kt >= nj) break;
          // A column c <- token 2c, c + 4 <- token 2c + 1
          FragA<RAW> pa;
          pa.set(s[4 * kt], s[4 * kt + 2], s[4 * kt + 1], s[4 * kt + 3]);
          const int r0 = k0 + 8 * kt + 2 * c4;
#pragma unroll
          for (int pt = 0; pt < PT; ++pt)
            mma_acc<RAW, XIN>(&acc[4 * pt], pa,
                               el<T>(vs, L.vp, r0, 8 * pt + g8),
                               el<T>(vs, L.vp, r0 + 1, 8 * pt + g8));
        }
      }
#pragma unroll
      for (int pt = 0; pt < PT; ++pt) {
        const int p = p0 + 8 * pt + 2 * c4;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = half ? rb : ra;
          if (r >= chunk || p >= p0 + pw) continue;
          float* yr = y + (((size_t)b * S + t0 + r) * H + h) * P + p;
          const float a0 = acc[4 * pt + 2 * half];
          const float a1 = acc[4 * pt + 2 * half + 1];
          if (p + 1 < p0 + pw && (P & 1) == 0) {
            *reinterpret_cast<float2*>(yr) = make_float2(a0, a1);
          } else {
            yr[0] = a0;
            if (p + 1 < p0 + pw) yr[1] = a1;
          }
        }
      }
    }

    // ---- state handoff: 16 x 32 tiles of C ----
    // Each tile goes to the warp with the least work so far, counting a
    // row block's scores and S v products first (in mma triples: 2 nk +
    // 2 PT a key block, 4 nkt a tile), so the short row blocks take them.
    const float carry = expf(bc[chunk - 1]);
    int load[WARPS];
    for (int w = 0; w < WARPS; ++w) {
      const int r = row_block(w);
      load[w] = 16 * r < chunk ? (r + 1) * (2 * nk + 2 * PT) : 0;
    }
    for (int u = 0; u < ((SSM_ABLATE & 4) ? 0 : units); ++u) {
      int best = 0;
      for (int w = 1; w < WARPS; ++w)
        if (load[w] < load[best]) best = w;
      load[best] += 4 * nkt;
      if (best != warp) continue;
      const int r0 = 16 * (u / (PD / 32)), pc = 32 * (u % (PD / 32));
      // (k sc)^T v over the chunk's 8-token steps, even and odd steps in
      // two sets of accumulators (eight independent mma chains, not four);
      // sum_j k_j sc_j (n's update) from the same A values, in fp32
      float d[2][16], nacc[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 16; ++i) d[0][i] = d[1][i] = 0.f;
      auto step = [&](int kt, float (&dk)[16]) {
        const int t = 8 * kt + 2 * c4;   // A column c <- token 2c, c + 4
        const float s0 = sc[t], s1 = sc[t + 1];   // <- token 2c + 1
        const float x0 = el<T>(kst, L.qp, t, r0 + g8) * s0;
        const float x1 = el<T>(kst, L.qp, t, r0 + g8 + 8) * s0;
        const float x2 = el<T>(kst, L.qp, t + 1, r0 + g8) * s1;
        const float x3 = el<T>(kst, L.qp, t + 1, r0 + g8 + 8) * s1;
        nacc[0] += x0 + x2;
        nacc[1] += x1 + x3;
        FragA<RAW> a;
        a.set(x0, x1, x2, x3);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_acc<RAW, XIN>(&dk[4 * nt], a,
                             el<T>(vs, L.vp, t, pc + 8 * nt + g8),
                             el<T>(vs, L.vp, t + 1, pc + 8 * nt + g8));
      };
      for (int kt = 0; kt < nkt; kt += 2) {
        step(kt, d[0]);
        if (kt + 1 < nkt) step(kt + 1, d[1]);
      }
      if (pc == 0 && blockIdx.y == 0) {   // n over the lanes of a quad
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          nacc[0] += __shfl_xor_sync(FULL, nacc[0], o);
          nacc[1] += __shfl_xor_sync(FULL, nacc[1], o);
        }
        if (c4 == 0) {
          ns[r0 + g8] = ns[r0 + g8] * carry + nacc[0];
          ns[r0 + g8 + 8] = ns[r0 + g8 + 8] * carry + nacc[1];
        }
      }
      float* cr = Cs + (r0 + g8) * L.cp + pc + 2 * c4;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float* c = cr + 8 * nt;
        c[0] = c[0] * carry + (d[0][4 * nt] + d[1][4 * nt]);
        c[1] = c[1] * carry + (d[0][4 * nt + 1] + d[1][4 * nt + 1]);
        c[8 * L.cp] = c[8 * L.cp] * carry + (d[0][4 * nt + 2] +
                                             d[1][4 * nt + 2]);
        c[8 * L.cp + 1] = c[8 * L.cp + 1] * carry + (d[0][4 * nt + 3] +
                                                     d[1][4 * nt + 3]);
      }
    }
    if (stages == 1 && ci + 1 < n_chunks) {
      __syncthreads();   // the one stage is free
      issue(ci + 1);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < N * pw; idx += THREADS) {
    const int n = idx / pw, p = idx - n * pw;
    c_out[((size_t)bh * N + n) * P + p0 + p] = Cs[n * L.cp + p];
  }
  if (blockIdx.y == 0)
    for (int d = tid; d < N; d += THREADS) n_out[(size_t)bh * N + d] = ns[d];
}

// ---- the step kernel (chunk == 1) -----------------------------------------

// Shared memory of a step block, in floats: q, k (N), v (P), the q C
// partials [rows a pass, P] and g (q . k).
__host__ __device__ inline int step_groups(int P, int vec) {
  const int cg = P / vec;
  return cg < STEP_THREADS ? cg : STEP_THREADS;
}
size_t step_smem(int N, int P, int vec) {
  const int rg = STEP_THREADS / step_groups(P, vec);
  return sizeof(float) * ((size_t)2 * N + P + (size_t)rg * P + 1);
}

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using type = float4;
  __device__ __forceinline__ static float get(const float4& x, int i) {
    return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
  }
  __device__ __forceinline__ static void set(float4& x, int i, float f) {
    if (i == 0) x.x = f; else if (i == 1) x.y = f;
    else if (i == 2) x.z = f; else x.w = f;
  }
};
template <>
struct Vec<1> {
  using type = float;
  __device__ __forceinline__ static float get(const float& x, int) {
    return x;
  }
  __device__ __forceinline__ static void set(float& x, int, float f) {
    x = f;
  }
};

// Thread t owns column group t % groups (VEC columns) and rows t / groups,
// t / groups + rows_a_pass, ...
template <typename T, int VEC>
__global__ void __launch_bounds__(STEP_THREADS)
ssm_step_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ la,
                const float* __restrict__ lg, const float* c0,
                const float* __restrict__ n0, float* __restrict__ y,
                float* c_out, float* __restrict__ n_out, Strides st, int S,
                int H, int N, int P) {
  using V = Vec<VEC>;
  using VT = typename V::type;
  extern __shared__ __align__(16) float smf[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int groups = step_groups(P, VEC), cgs = P / VEC;
  const int rg_n = STEP_THREADS / groups;
  const int cg = tid % groups, rg = tid / groups;
  float* qs = smf;
  float* kst = qs + N;
  float* vs = kst + N;
  float* part = vs + P;            // [rg_n, P]
  float* gqk = part + rg_n * P;    // g (q . k)
  const size_t cbase = (size_t)bh * N * P;

  for (int t = 0; t < S; ++t) {
    const size_t g = ((size_t)b * S + t) * H + h;
    const float a = expf(la[g]), gain = clip_exp(lg[g]);
    for (int d = tid; d < N; d += STEP_THREADS) {
      qs[d] = to_f(q[b * st.q[0] + t * st.q[1] + h * st.q[2] +
                     d * st.q[3]]);
      kst[d] = to_f(k[b * st.k[0] + t * st.k[1] + h * st.k[2] +
                      d * st.k[3]]);
    }
    for (int p = tid; p < P; p += STEP_THREADS)
      vs[p] = to_f(v[b * st.v[0] + t * st.v[1] + h * st.v[2] +
                     p * st.v[3]]);
    __syncthreads();
    if (tid < 32) {
      float s = 0.f;
      for (int d = lane; d < N; d += 32) s += qs[d] * kst[d];
      for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
      if (lane == 0) *gqk = s * gain;
    }
    const float* src = t == 0 ? c0 : c_out;
    if (rg < rg_n) {
      for (int c = cg; c < cgs; c += groups) {
        float yp[VEC], vv[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          yp[i] = 0.f;
          vv[i] = vs[VEC * c + i];
        }
        // ROWS rows a batch: every load in flight before the first store
        // (c_out may be the source, so the compiler would not reorder them)
        for (int nb = rg; nb < N; nb += ROWS * rg_n) {
          VT x[ROWS];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const int n = nb + r * rg_n;
            if (src && n < N) {
              x[r] = *reinterpret_cast<const VT*>(src + cbase +
                                                  (size_t)n * P + VEC * c);
            } else {
#pragma unroll
              for (int i = 0; i < VEC; ++i) V::set(x[r], i, 0.f);
            }
          }
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const int n = nb + r * rg_n;
            if (n >= N) break;
            const float qn = qs[n], kg = kst[n] * gain;
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
              const float cv = V::get(x[r], i);
              yp[i] = fmaf(qn, cv, yp[i]);
              V::set(x[r], i, cv * a + kg * vv[i]);
            }
            *reinterpret_cast<VT*>(c_out + cbase + (size_t)n * P + VEC * c) =
                x[r];
          }
        }
#pragma unroll
        for (int i = 0; i < VEC; ++i) part[rg * P + VEC * c + i] = yp[i];
      }
    }
    for (int d = tid; d < N; d += STEP_THREADS) {
      const float nv = (t == 0) ? (n0 ? n0[(size_t)bh * N + d] : 0.f)
                                : n_out[(size_t)bh * N + d];
      n_out[(size_t)bh * N + d] = nv * a + kst[d] * gain;
    }
    __syncthreads();
    const float qk = *gqk;
    for (int p = tid; p < P; p += STEP_THREADS) {
      float s = 0.f;
      for (int r = 0; r < rg_n; ++r) s += part[r * P + p];
      y[g * P + p] = s * a + qk * vs[p];
    }
    __syncthreads();   // q, k, v and the partials are free for t + 1
  }
}

// ---- launch ----------------------------------------------------------------

// Whether every row of nel values of a [B, S, H, D] tensor of esize-byte
// values is whole 16-byte copies (value stride 1, base, row strides and
// row length multiples of 16 bytes).
bool copies16(const void* base, const long long* s, int esize, int nel) {
  bool ok = s[3] == 1 && (uintptr_t)base % 16 == 0 && (nel * esize) % 16 == 0;
  for (int i = 0; i < 3; ++i) ok = ok && (s[i] * esize) % 16 == 0;
  return ok;
}

template <typename T, int PD, bool CACHEQ>
int launch_chunk(const void* q, const void* k, const void* v, const void* la,
                 const void* lg, const void* c0, const void* n0, void* y,
                 void* c_out, void* n_out, const Strides& st, int B, int S,
                 int H, int N, int P, int chunk, cudaStream_t stream) {
  const int es = (int)sizeof(T);
  const int stages = chunk_stages(N, PD, chunk, es);
  const size_t smem = Layout(N, PD, chunk, es, stages).total;
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kern = ssm_chunk_kernel<T, PD, CACHEQ>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  // v slices start at multiples of PD values (multiples of 64 bytes), so
  // the shortest slice, the last, decides v's copies
  const Copy16 w{copies16(q, st.q, es, N), copies16(k, st.k, es, N),
                 copies16(v, st.v, es, P % PD ? P % PD : PD)};
  dim3 grid(B * H, (P + PD - 1) / PD);
  kern<<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)la,
      (const float*)lg, (const float*)c0, (const float*)n0, (float*)y,
      (float*)c_out, (float*)n_out, st, w, S, H, N, P, chunk, stages);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_step(const void* q, const void* k, const void* v, const void* la,
                const void* lg, const void* c0, const void* n0, void* y,
                void* c_out, void* n_out, const Strides& st, int B, int S,
                int H, int N, int P, cudaStream_t stream) {
  // 16-byte state rows where P allows them (the wrapper aligns the state)
  const int vec = (P % 4 == 0) ? 4 : 1;
  const size_t smem = step_smem(N, P, vec);
  if (smem > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kern = vec == 4 ? ssm_step_kernel<T, 4> : ssm_step_kernel<T, 1>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<B * H, STEP_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)la,
      (const float*)lg, (const float*)c0, (const float*)n0, (float*)y,
      (float*)c_out, (float*)n_out, st, S, H, N, P);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* la,
             const void* lg, const void* c0, const void* n0, void* y,
             void* c_out, void* n_out, const Strides& st, int B, int S, int H,
             int N, int P, int chunk, int p_slice, cudaStream_t s) {
  if (chunk == 1)
    return launch_step<T>(q, k, v, la, lg, c0, n0, y, c_out, n_out, st, B, S,
                          H, N, P, s);
  const bool cache = N <= 64;
  if (p_slice == 32)
    return cache ? launch_chunk<T, 32, true>(q, k, v, la, lg, c0, n0, y,
                                             c_out, n_out, st, B, S, H, N, P,
                                             chunk, s)
                 : launch_chunk<T, 32, false>(q, k, v, la, lg, c0, n0, y,
                                              c_out, n_out, st, B, S, H, N,
                                              P, chunk, s);
  return cache ? launch_chunk<T, 64, true>(q, k, v, la, lg, c0, n0, y, c_out,
                                           n_out, st, B, S, H, N, P, chunk, s)
               : launch_chunk<T, 64, false>(q, k, v, la, lg, c0, n0, y,
                                            c_out, n_out, st, B, S, H, N, P,
                                            chunk, s);
}

}  // namespace

// Dynamic shared memory one block needs, in bytes, on the route the chunk
// picks (chunk 1: the step kernel; else the chunk kernel with p_slice
// columns of P a block, at the stage count it would take). dtype: 0 =
// float32, 1 = bfloat16. The wrapper refuses shapes above 232448.
extern "C" long long ssm_chunk_scan_smem(int dtype, int N, int P, int chunk,
                                         int p_slice) {
  if (chunk == 1) return (long long)step_smem(N, P, P % 4 == 0 ? 4 : 1);
  const int es = dtype == 1 ? 2 : 4;
  return (long long)Layout(N, p_slice, chunk, es,
                           chunk_stages(N, p_slice, chunk, es)).total;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k and v share it); strides: 12
// element strides, (b, s, h, d) of q, then k, then v. c0 / n0 may be null
// (a fresh sequence); c0 16-byte aligned. p_slice (32 or 64) is the number
// of P columns a chunk-kernel block owns. The caller guarantees 1 <= chunk
// <= 128, S % chunk == 0 and contiguous fp32 la, lg, c0, n0, y, c_out,
// n_out. Returns cudaGetLastError() after the launch.
extern "C" int ssm_chunk_scan(int dtype, const void* q, const void* k,
                              const void* v, const void* la, const void* lg,
                              const void* c0, const void* n0, void* y,
                              void* c_out, void* n_out,
                              const long long* strides, int B, int S, int H,
                              int N, int P, int chunk, int p_slice,
                              void* stream) {
  if (chunk < 1 || chunk > MAX_CHUNK || S % chunk ||
      (p_slice != 32 && p_slice != 64) ||
      ssm_chunk_scan_smem(dtype, N, P, chunk, p_slice) > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 4; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[4 + i];
    st.v[i] = strides[8 + i];
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, la, lg, c0, n0, y, c_out, n_out,
                                   st, B, S, H, N, P, chunk, p_slice, s);
  return dispatch<float>(q, k, v, la, lg, c0, n0, y, c_out, n_out, st, B, S,
                         H, N, P, chunk, p_slice, s);
}
