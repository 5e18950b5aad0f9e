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
// What bounds it: at prefill lengths, the arithmetic - 4*H*D operations per
// causal (query, key) pair against q, k, v and o read or written once. On
// the tensor cores that is 989 TFLOP/s for bf16 inputs and, for fp32 inputs
// computed as three TF32 products (below), 495/3 TFLOP/s.
//
// Design. One block per (batch row, kv head, query tile) holds one consumer
// warpgroup (4 warps) and one producer warp. The 64 query rows of a tile
// are the G query heads of the kv head times 64/G positions (row r is
// position r / G, head r % G), so K and V are read once for the whole
// group. The consumers stage the q tile in shared memory once (every load
// in flight before the first store); the producer warp's first lane streams
// 64-token K and V tiles by TMA (a 4-d tensor map [B, Skv, KVH, D], built
// in the C entry point, whose zero fill covers a ragged Skv and the columns
// past D) into a ring of STAGES stages, each guarded by a "full" mbarrier
// (TMA bytes landed) and an "empty" one (the four consumer warps are done
// with it). Blocks of the longest query tiles are launched first. (Two
// consumer warpgroups sharing one ring, 128 rows a block, measured slower:
// their registers left one block an SM where one warpgroup gets three.)
// Every tile sits in shared memory as rows of 128 bytes with the 128-byte
// swizzle (16-byte chunk c of row r at chunk c ^ (r & 7)), D cut into slabs
// of 128 bytes (64 bf16 or 32 fp32 values), so neither the tensor cores nor
// the fragment loads below meet a bank conflict. Softmax runs online on the
// score fragments in registers (the row max and sum reduced over the four
// lanes of a quad), in base 2 with the 1/sqrt(D) folded into the
// exponent's scale.
//
// * bf16 inputs: S = Q.K^T is wgmma.m64n64k16 with Q and K K-major in
//   shared memory; P is rounded to bf16 (the TPU kernel's
//   p.astype(v.dtype)) and fed from registers as the A operand of P.V,
//   wgmma.m64nNk16 with V as the B operand in its stored [tokens, D] layout
//   (the transpose bit), N = 64 or 128. fp32 accumulation throughout. Each
//   product is waited for before the softmax that needs it; overlapping S
//   of tile i + 1 and P.V of tile i - 1 with the softmax of tile i (two
//   score fragments in flight) measured slower on the H100, 0.085 against
//   0.061 ms at the llama shape.
// * fp32 inputs: every product is three TF32 tensor-core products, x = hi +
//   lo with hi = rna(x), lo = rna(x - hi) where rna is cvt.rna.tf32's
//   rounding (integer operations: tf32_mma.cuh's tf32_rna), and a.b =
//   hi.hi + hi.lo + lo.hi with fp32 accumulation (the dropped lo.lo term is
//   ~2^-22 of the product), which holds the fp32 tolerance where one TF32
//   product (~3 digits) would not. The route is mma.sync.m16n8k8.tf32, each
//   warp owning 16 of the 64 rows: its fragments come from shared memory by
//   plain 32-bit loads and are split in registers (ldmatrix takes 16-bit
//   types only; 16-byte loads of Q and K, by permuting the reduction's
//   order, measured no faster). TF32 wgmma was the other route; it needs both operands
//   K-major in shared memory, so each tile's V would have to be transposed
//   and the hi / lo halves of K and V written back to shared memory, three
//   more passes over every tile, and the split would still happen on the
//   CUDA cores. P.V takes P straight from the score fragment: the mma's k
//   order is permuted (A column c <- token 2c, c + 4 <- token 2c + 1, with
//   V's rows read to match), so no shuffle is needed.
//
// The output is divided by max(l, 1e-30), as in the TPU kernel; a row that
// sees no key gives 0.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem_limit.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int ROWS = 64;                 // query rows a block
constexpr int TOK = 64;                  // key / value tokens a stage
constexpr int CONSUMERS = 128;           // one consumer warpgroup
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int ERR_TENSOR_MAP = 10000;    // + the CUresult of a failed encode

template <typename T, int NSLAB>
struct Cfg {
  static constexpr int SLAB = 128 / (int)sizeof(T);   // values a slab row
  // bf16 at D <= 64 takes two stages so four blocks fit an SM (measured
  // faster than three stages and three blocks); fp32 and bf16 at D > 64
  // are bound to two blocks an SM by their tiles anyway
  static constexpr int STAGES = (sizeof(T) == 2 && NSLAB > 1) ? 3 : 2;
  static constexpr int Q_BYTES = ROWS * 128 * NSLAB;
  static constexpr int KV_BYTES = TOK * 128 * NSLAB;  // one K or V stage
  static constexpr int SMEM =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 2 * STAGES * 8;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// byte offset of 16-byte chunk ch of row r in a tile of 128-byte rows under
// the 128-byte swizzle (the layout TMA writes and wgmma reads)
__device__ __forceinline__ int swz(int r, int ch) {
  return r * 128 + ((ch ^ (r & 7)) << 4);
}

// ---- mbarriers and TMA ----------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// ---- wgmma (bf16) ----------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep the compiler from moving reads / writes of accumulator registers
// across the asynchronous wgmma region
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; lbo / sbo in bytes
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B K-major in shared
// memory (128-byte swizzle), bf16 in, fp32 accumulate.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers (bf16 pairs), B
// MN-major in shared memory (128-byte swizzle, transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A in registers (bf16 pairs), B
// MN-major in shared memory (128-byte swizzle, transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

using namespace tf32mma;

// ---- the two products of a tile --------------------------------------------
//
// Score and output fragments share one layout (the wgmma accumulator, which
// is the mma.sync m16n8 one per warp): value i of a thread sits at row
// 16 * warp + lane / 4 + 8 * ((i >> 1) & 1), column 8 * (i >> 2) +
// 2 * (lane & 3) + (i & 1).

template <typename T, int NSLAB>
struct Mma;

template <int NSLAB>
struct Mma<__nv_bfloat16, NSLAB> {
  static constexpr int OREGS = 32 * NSLAB;
  // s = Q.K^T of one stage (the first product ignores s's old values)
  __device__ __forceinline__ static void scores(float (&s)[32],
                                                const uint8_t* qs,
                                                const uint8_t* kst) {
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NSLAB; ++kk) {
      const int off = (kk % 4) * 32;
      wgmma_ss_n64(s, gmma_desc(qs + (kk / 4) * ROWS * 128 + off, 16, 1024),
                   gmma_desc(kst + (kk / 4) * TOK * 128 + off, 16, 1024),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
  }
  // o += bf16(p).V of one stage
  __device__ __forceinline__ static void pv(float (&o)[OREGS],
                                            const float (&p)[32],
                                            const uint8_t* vst) {
    uint32_t a[4][4];
#pragma unroll
    for (int kt = 0; kt < 4; ++kt)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        a[kt][x] = pack_bf16(p[8 * kt + 2 * x], p[8 * kt + 2 * x + 1]);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
      const uint64_t db = gmma_desc(vst + kt * 16 * 128, TOK * 128, 1024);
      if constexpr (NSLAB == 1)
        wgmma_rs_n64(o, a[kt], db);
      else
        wgmma_rs_n128(o, a[kt], db);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);
  }
};

template <int NSLAB>
struct Mma<float, NSLAB> {
  static constexpr int OREGS = 16 * NSLAB;
  __device__ __forceinline__ static void scores(float (&s)[32],
                                                const uint8_t* qs,
                                                const uint8_t* kst) {
    const int lane = threadIdx.x & 31, g8 = lane >> 2, c4 = lane & 3;
    const int ra = 16 * (threadIdx.x >> 5) + g8, rb = ra + 8;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4 * NSLAB; ++ks) {
      const uint8_t* qsl = qs + (ks / 4) * ROWS * 128 + 4 * c4;
      const uint8_t* ksl = kst + (ks / 4) * TOK * 128 + 4 * c4;
      const int ch0 = 2 * (ks % 4), ch1 = ch0 + 1;
      const FragA<RNA> a(lds(qsl + swz(ra, ch0)), lds(qsl + swz(rb, ch0)),
                         lds(qsl + swz(ra, ch1)), lds(qsl + swz(rb, ch1)));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int rk = 8 * j + g8;
        mma_acc<RNA, RNA>(&s[4 * j], a, lds(ksl + swz(rk, ch0)),
                          lds(ksl + swz(rk, ch1)));
      }
    }
  }
  __device__ __forceinline__ static void pv(float (&o)[OREGS],
                                            const float (&p)[32],
                                            const uint8_t* vst) {
    const int lane = threadIdx.x & 31, g8 = lane >> 2, c4 = lane & 3;
#pragma unroll
    for (int kt = 0; kt < 8; ++kt) {
      // A column c <- token 2c, c + 4 <- token 2c + 1 (see the note)
      const FragA<RNA> a(p[4 * kt], p[4 * kt + 2], p[4 * kt + 1],
                         p[4 * kt + 3]);
      const int r0 = 8 * kt + 2 * c4;
#pragma unroll
      for (int dn = 0; dn < 4 * NSLAB; ++dn) {
        const uint8_t* vsl = vst + (dn / 4) * TOK * 128 + 4 * (g8 & 3);
        const int ch = 2 * (dn % 4) + (g8 >> 2);
        mma_acc<RNA, RNA>(&o[4 * dn], a, lds(vsl + swz(r0, ch)),
                          lds(vsl + swz(r0 + 1, ch)));
      }
    }
  }
};

// ---- the kernel ------------------------------------------------------------

// Copy the [ROWS, 128 * NSLAB bytes] q tile into shared memory (swizzled
// slabs, zero past D and past the tile's rows). Consumer threads only.
template <typename T, int NSLAB>
__device__ __forceinline__ void load_q(uint8_t* qs, const T* __restrict__ q,
                                       int b, int h, int Sq, int H, int D,
                                       int G, int qblk, int q0) {
  constexpr int EPC = 16 / (int)sizeof(T);   // values a 16-byte chunk
  constexpr int CPR = 8 * NSLAB;             // chunks a padded row
  constexpr int N = ROWS * CPR / CONSUMERS;  // chunks a thread
  uint4 val[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {   // every load in flight before any store
    const int idx = threadIdx.x + CONSUMERS * i;
    const int r = idx / CPR, ch = idx - r * CPR;
    const int qi = r / G, g = r - qi * G, d0 = ch * EPC;
    val[i] = make_uint4(0u, 0u, 0u, 0u);
    if (qi < qblk && q0 + qi < Sq && d0 < D)
      val[i] = *reinterpret_cast<const uint4*>(
          q + (((size_t)b * Sq + q0 + qi) * H + h * G + g) * D + d0);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int idx = threadIdx.x + CONSUMERS * i;
    const int r = idx / CPR, ch = idx - r * CPR;
    *reinterpret_cast<uint4*>(qs + (ch / 8) * ROWS * 128 + swz(r, ch % 8)) =
        val[i];
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// What the online softmax of a consumer thread needs: its quad lane, the
// positions of its two rows, the tile's first and last positions, and the
// masks.
struct Rowstate {
  int c4, pos0, pos1, pos_lo, pos_hi, Skv, causal, window;
  float scale_log2;
};

__device__ __forceinline__ float ex2(float x) {   // 2^x, one MUFU op
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax of one score tile in place, base 2: s (raw scores) becomes
// the probabilities, m / l advance, corr is the factor for the accumulator.
// A tile that crosses Skv, the causal frontier or the window edge is masked
// element by element. Returns whether a row of this warp raised its max:
// otherwise every corr is 1 and the accumulator needs no rescale.
__device__ __forceinline__ bool softmax_tile(float (&s)[32], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int t0, const Rowstate& rs) {
  const bool edge = t0 + TOK > rs.Skv ||
                    (rs.causal && t0 + TOK - 1 > rs.pos_lo) ||
                    (rs.window > 0 && t0 <= rs.pos_hi - rs.window);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (edge) {
      const int t = t0 + 8 * (i >> 2) + 2 * rs.c4 + (i & 1);
      const int pos = (i & 2) ? rs.pos1 : rs.pos0;
      const bool ok = t < rs.Skv && (!rs.causal || t <= pos) &&
                      (rs.window <= 0 || t > pos - rs.window);
      s[i] = ok ? s[i] : -INFINITY;
    }
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
  float mu[2], sum[2] = {0.f, 0.f};
  bool raised = false;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // the scale is positive, so the max of the scaled scores is the
    // scaled max
    const float mn = fmaxf(m[r], mx[r] * rs.scale_log2);
    raised = raised || mn > m[r];
    mu[r] = mn == -INFINITY ? 0.f : mn;   // a row with no live key yet
    corr[r] = ex2(m[r] - mu[r]);
    m[r] = mn;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float p = ex2(fmaf(s[i], rs.scale_log2, -mu[(i >> 1) & 1]));
    s[i] = p;
    sum[(i >> 1) & 1] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l[r] = l[r] * corr[r] + sum[r];
  }
  return __any_sync(0xffffffffu, raised);
}

// q [B, Sq, H, D]; k/v [B, Skv, KVH, D] (through kmap / vmap); out
// [B, Sq, H, D]; q_off [B]. Query row i of batch row b sits at position
// q_off[b] + i. The body of both kernels below.
template <typename T, int NSLAB>
__device__ __forceinline__ void attend(
    const CUtensorMap& kmap, const CUtensorMap& vmap, const T* __restrict__ q,
    T* __restrict__ out, const int* __restrict__ q_off, int B, int Sq,
    int Skv, int H, int KVH, int D, int G, int qblk, int n_qt, int causal,
    int window, float scale_log2) {
  using C = Cfg<T, NSLAB>;
  using M = Mma<T, NSLAB>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = qs + C::Q_BYTES;
  uint8_t* vs = ks + C::STAGES * C::KV_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + C::STAGES * C::KV_BYTES);
  uint64_t* empty = full + C::STAGES;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x % (B * KVH);
  const int qt = n_qt - 1 - blockIdx.x / (B * KVH);   // longest tiles first
  const int h = bh % KVH, b = bh / KVH;
  const int off = q_off[b];
  const int q0 = qt * qblk;
  const int q_last = min(q0 + qblk, Sq) - 1;
  const int kv_hi = causal ? min(Skv, off + q_last + 1) : Skv;
  int kv_lo = window > 0 ? max(0, off + q0 - window + 1) : 0;
  kv_lo = (kv_lo / TOK) * TOK;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + TOK - 1) / TOK : 0;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {   // the producer warp: one lane issues the TMA
    if (tid == CONSUMERS) {
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % C::STAGES;
        if (it >= C::STAGES) mbar_wait(&empty[st], (it / C::STAGES - 1) & 1);
        mbar_expect_tx(&full[st], 2 * C::KV_BYTES);
        const int t0 = kv_lo + it * TOK;
#pragma unroll
        for (int s = 0; s < NSLAB; ++s) {
          const int at = st * C::KV_BYTES + s * TOK * 128;
          tma_load_4d(ks + at, &kmap, &full[st], s * C::SLAB, h, t0, b);
          tma_load_4d(vs + at, &vmap, &full[st], s * C::SLAB, h, t0, b);
        }
      }
    }
    return;
  }

  load_q<T, NSLAB>(qs, q, b, h, Sq, H, D, G, qblk, q0);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");

  const int lane = tid & 31;
  const int r0 = 16 * (tid >> 5) + (lane >> 2), r1 = r0 + 8;
  const Rowstate rs{lane & 3, off + q0 + r0 / G, off + q0 + r1 / G,
                    off + q0, off + q_last, Skv, causal, window, scale_log2};
  float o[M::OREGS];
#pragma unroll
  for (int i = 0; i < M::OREGS; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % C::STAGES;
    mbar_wait(&full[st], (it / C::STAGES) & 1);
    float s[32];
    M::scores(s, qs, ks + st * C::KV_BYTES);
    if (softmax_tile(s, m, l, corr, kv_lo + it * TOK, rs)) {
#pragma unroll
      for (int i = 0; i < M::OREGS; ++i) o[i] *= corr[(i >> 1) & 1];
    }
    M::pv(o, s, vs + st * C::KV_BYTES);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? r1 : r0;
    const int qi = row / G, g = row - qi * G;
    if (qi >= qblk || q0 + qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* orow = out + (((size_t)b * Sq + q0 + qi) * H + h * G + g) * D;
#pragma unroll
    for (int j = 0; j < M::OREGS / 4; ++j) {
      const int d = 8 * j + 2 * rs.c4;
      if (d < D) store2(orow + d, o[4 * j + 2 * r] * inv,
                        o[4 * j + 2 * r + 1] * inv);
    }
  }
}

// ---- host side -------------------------------------------------------------

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult qr;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &qr);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &qr);
#endif
    if (e == cudaSuccess && qr == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [B, Skv, KVH, D] as a 4-d map, innermost first; a box is one 128-byte slab
// of TOK tokens of one head
template <typename T, int NSLAB>
int kv_map(CUtensorMap* map, const void* base, int B, int Skv, int KVH,
           int D) {
  EncodeTiled enc = encoder();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t es = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)KVH,
                              (cuuint64_t)Skv, (cuuint64_t)B};
  const cuuint64_t strides[3] = {D * es, (cuuint64_t)KVH * D * es,
                                 (cuuint64_t)Skv * KVH * D * es};
  const cuuint32_t box[4] = {(cuuint32_t)Cfg<T, NSLAB>::SLAB, 1, TOK, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map,
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      4, const_cast<void*>(base), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP + (int)r;
}

#define FA_PARAMS(T)                                                       \
  const __grid_constant__ CUtensorMap kmap,                                \
      const __grid_constant__ CUtensorMap vmap, const T *__restrict__ q,   \
      T *__restrict__ out, const int *__restrict__ q_off, int B, int Sq,   \
      int Skv, int H, int KVH, int D, int G, int qblk, int n_qt,           \
      int causal, int window, float scale_log2
#define FA_ARGS                                                            \
  kmap, vmap, q, out, q_off, B, Sq, Skv, H, KVH, D, G, qblk, n_qt, causal, \
      window, scale_log2

// bf16 at D <= 64 asks for four blocks an SM (at most 96 registers a
// thread); fp32 leaves the register count to the compiler (asking for two
// blocks made it take more registers and run 1.5x slower).
template <int NSLAB>
__global__ void __launch_bounds__(THREADS, NSLAB == 1 ? 4 : 2)
flash_fwd_bf16(FA_PARAMS(__nv_bfloat16)) {
  attend<__nv_bfloat16, NSLAB>(FA_ARGS);
}
template <int NSLAB>
__global__ void __launch_bounds__(THREADS) flash_fwd_fp32(FA_PARAMS(float)) {
  attend<float, NSLAB>(FA_ARGS);
}
#undef FA_PARAMS
#undef FA_ARGS

template <typename T, int NSLAB>
int launch(const void* q, const void* k, const void* v, void* out,
           const void* q_off, int B, int Sq, int Skv, int H, int KVH, int D,
           int causal, int window, cudaStream_t stream) {
  using C = Cfg<T, NSLAB>;
  CUtensorMap kmap, vmap;
  int e = kv_map<T, NSLAB>(&kmap, k, B, Skv, KVH, D);
  if (e) return e;
  e = kv_map<T, NSLAB>(&vmap, v, B, Skv, KVH, D);
  if (e) return e;
  const int G = H / KVH;
  const int qblk = ROWS / G;
  const int n_qt = (Sq + qblk - 1) / qblk;
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  auto go = [&](auto kern) {
    const cudaError_t ce = allow_smem(kern, C::SMEM);
    if (ce != cudaSuccess) return (int)ce;
    kern<<<n_qt * B * KVH, THREADS, C::SMEM, stream>>>(
        kmap, vmap, (const T*)q, (T*)out, (const int*)q_off, B, Sq, Skv, H,
        KVH, D, G, qblk, n_qt, causal, window, scale_log2);
    return (int)cudaGetLastError();
  };
  if constexpr (sizeof(T) == 2)
    return go(flash_fwd_bf16<NSLAB>);
  else
    return go(flash_fwd_fp32<NSLAB>);
}

// The fp32 operand split of the kernel (by_cvt = 0) or the same split with
// the cvt.rna.tf32 instruction (by_cvt = 1), element by element, for the
// tests that hold the two and the wrapper's plain model (tf32_split) to one
// another.
__global__ void tf32_split_kernel(const float* __restrict__ x,
                                  float* __restrict__ hi,
                                  float* __restrict__ lo, int n, int by_cvt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t h, l;
  if (by_cvt) {
    h = tf32_rna_cvt(x[i]);
    l = tf32_rna_cvt(x[i] - __uint_as_float(h));
  } else {
    as_tf32<RNA>(x[i], h, l);
  }
  hi[i] = __uint_as_float(h);
  lo[i] = __uint_as_float(l);
}

}  // namespace

// Dynamic shared memory a block takes for dtype (0 = float32, 1 =
// bfloat16) at head dimension D: the q tile, the K / V ring and its
// barriers.
extern "C" long long flash_attention_smem(int dtype, int D) {
  if (dtype == 1) return D <= 64 ? Cfg<__nv_bfloat16, 1>::SMEM
                                 : Cfg<__nv_bfloat16, 2>::SMEM;
  return D <= 32 ? Cfg<float, 1>::SMEM : D <= 64 ? Cfg<float, 2>::SMEM
       : D <= 96 ? Cfg<float, 3>::SMEM : Cfg<float, 4>::SMEM;
}

extern "C" int flash_attention_tf32_split(const void* x, void* hi, void* lo,
                                          int n, int by_cvt, void* stream) {
  if (n <= 0) return 0;
  tf32_split_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)hi, (float*)lo, n, by_cvt);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). The caller
// guarantees D <= 128 with D * sizeof(dtype) a multiple of 16, 16-byte
// aligned base pointers, H % KVH == 0, H / KVH <= 64, contiguous tensors
// and an int32 q_off [B]. Returns cudaGetLastError() after the launch, or
// 10000 + the CUresult of a tensor map the driver refused.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* out, const void* q_off,
                                   int B, int Sq, int Skv, int H, int KVH,
                                   int D, int causal, int window,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define FA_ARGS q, k, v, out, q_off, B, Sq, Skv, H, KVH, D, causal, window, st
  if (dtype == 1) {
    if (D <= 64) return launch<__nv_bfloat16, 1>(FA_ARGS);
    return launch<__nv_bfloat16, 2>(FA_ARGS);
  }
  if (D <= 32) return launch<float, 1>(FA_ARGS);
  if (D <= 64) return launch<float, 2>(FA_ARGS);
  if (D <= 96) return launch<float, 3>(FA_ARGS);
  return launch<float, 4>(FA_ARGS);
#undef FA_ARGS
}
