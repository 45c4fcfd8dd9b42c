// The "wgmma" path of flash_attention: bf16 attention with many query rows
// per KV head (prefill), on Hopper's tensor cores.  Included by
// flash_attention.cu; see the design note there.
//
// One CTA of three warpgroups per (batch, query head, tile of 128 query
// rows).  Warpgroup 2 is the producer: after lowering its registers with
// setmaxnreg, one thread loads the Q tile once and then K/V tiles of 128
// keys through TMA into a ring of kStages stages, each with a "full" and an
// "empty" mbarrier.  Warpgroups 0 and 1 are consumers, 64 query rows each:
// per tile, S = Q.K^T by wgmma from two shared-memory descriptors, the
// online softmax on the fp32 accumulator in registers, then O += P.V by
// wgmma with P converted in registers from the S accumulator to bf16 pairs
// (the accumulator's layout is the A operand's) and V read transposed from
// shared memory.
//
// Shared-memory layout: every tile (Q, K or V) is hd / 64 chunks of
// [128 rows][64 bf16], one 128-byte row per query or key, written by TMA
// with the 128-byte swizzle (the wgmma descriptors' layout type 1).  Q and
// K are K-major operands (hd contiguous): an 8-row group is 1024 bytes
// (SBO), and the k-th 16-column step starts 32 bytes into the row.  V is
// the B operand of P.V with N = hd contiguous, MN-major: 8-key groups 1024
// bytes apart (SBO), the second 64-column chunk 16 KB on (LBO), the k-th
// 16-key step 2048 bytes on.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace wg {

constexpr int kRows = 128;        // query rows per CTA
constexpr int kKeys = 128;        // keys per K/V tile
constexpr int kConsumers = 2;     // warpgroups of 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kChunkBytes = 128 * 128;   // [128 rows][64 bf16]
constexpr float kNegInf = -1e30f;

template <int HD>
struct Cfg {
  static constexpr int kChunks = HD / 64;
  static constexpr int kStages = HD == 64 ? 3 : 2;
  static constexpr int kTileBytes = kChunks * kChunkBytes;
  // Q, the K and V rings, barriers, and slack to align the base to 1024
  static constexpr int kSmemBytes =
      kTileBytes * (1 + 2 * kStages) + 8 * (1 + 2 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Waits until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-d tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor, 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128]: A and B in shared memory,
// both K-major.
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64]: A in registers (bf16 pairs
// in the accumulator's layout), B in shared memory, MN-major (its
// transpose bit set).
__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128]: A in registers (bf16 pairs
// in the accumulator's layout), B in shared memory, MN-major (its
// transpose bit set).
__device__ __forceinline__ void mma_rs_n128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <int HD>
__device__ __forceinline__ void mma_pv(float (&o)[HD / 2],
                                       const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void mma_pv<64>(float (&o)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  mma_rs_n64(o, a, db, 1);
}
template <>
__device__ __forceinline__ void mma_pv<128>(float (&o)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  mma_rs_n128(o, a, db, 1);
}

// q [B*H][Sq][HD], k and v [B*K][Sk][HD] through their tensor maps, whose
// key rows stop at sk_valid (TMA reads the rest as zeros); out [B, H, Sq,
// HD].  Keys at or past sk_valid are masked, and if causal, key j for query
// row i when j > i + q_offset.  Scores are scaled by scale_log2 = log2(e) /
// sqrt(hd) and exponentiated with exp2.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             __nv_bfloat16* __restrict__ out, int B, int H, int K, int Sq,
             int sk_valid, int q_offset, float scale_log2, int causal) {
  using C = Cfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = q_s + C::kTileBytes;   // stage s at + s * kTileBytes
  const uint32_t v_s = k_s + C::kStages * C::kTileBytes;
  const uint32_t q_full = v_s + C::kStages * C::kTileBytes;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * C::kStages;

  // The heaviest causal tiles (the last query rows) are launched first, so
  // the grid's tail is short.  The G heads of one KV head are neighbours in
  // launch order and read the same K/V tiles at about the same time; at the
  // model shapes all of K and V (5 MB at smollm-360m's prefill) stays in the
  // 50 MB L2 anyway, so no packing of heads into one CTA is needed.
  const int n_qt = (Sq + kRows - 1) / kRows;
  const int bh = blockIdx.x % (B * H);
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / (B * H);
  const int b = bh / H, h = bh % H, kvh = h / (H / K);
  const int q0 = qt * kRows, off = q_offset;
  int kv_end = sk_valid;
  if (causal) kv_end = min(sk_valid, min(q0 + kRows, Sq) + off);
  const int n_kt = kv_end > 0 ? (kv_end + kKeys - 1) / kKeys : 0;

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---- producer ---------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (t == 0) {
      mbar_expect_tx(q_full, C::kTileBytes);
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c)
        tma_load_3d(q_s + c * kChunkBytes, &tm_q, q_full, 64 * c, q0, bh);
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % C::kStages;
        const uint32_t parity = (i / C::kStages) & 1;
        mbar_wait(empty0 + 8 * s, parity ^ 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, 2 * C::kTileBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) {
          const uint32_t at = s * C::kTileBytes + c * kChunkBytes;
          tma_load_3d(k_s + at, &tm_k, full, 64 * c, i * kKeys, b * K + kvh);
          tma_load_3d(v_s + at, &tm_v, full, 64 * c, i * kKeys, b * K + kvh);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int warp = t / 32, lane = t % 32;
    const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;   // and row0 + 8
    const int qpos0 = row0 + off, qpos1 = qpos0 + 8;
    const int wg_first = q0 + 64 * wg + off;   // query position of its row 0
    const int col0 = 2 * (lane % 4);
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_kt; ++i) {
      const int s = i % C::kStages;
      mbar_wait(full0 + 8 * s, (i / C::kStages) & 1);
      const int k0 = i * kKeys;
      // a tile past this warpgroup's last query row is all masked for it
      if (!causal || k0 <= wg_first + 63) {
        float sc[64];
#pragma unroll
        for (int j = 0; j < 64; ++j) sc[j] = 0.0f;
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t in_chunk = (kk / 4) * kChunkBytes + (kk % 4) * 32;
          mma_ss_n128(sc,
                      make_desc(q_s + in_chunk + wg * 64 * 128, 16, 1024),
                      make_desc(k_s + s * C::kTileBytes + in_chunk, 16, 1024),
                      kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);

        // scale; mask the ragged tail and, near the diagonal, the future
        const bool edge =
            k0 + kKeys > sk_valid || (causal && k0 + kKeys - 1 > wg_first);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = sc[4 * j + e] * scale_log2;
            if (edge) {
              const int key = k0 + 8 * j + col0 + (e & 1);
              if (key >= sk_valid ||
                  (causal && key > (e < 2 ? qpos0 : qpos1)))
                x = -INFINITY;
            }
            sc[4 * j + e] = x;
          }
        }
        // online softmax: each row lives on the 4 lanes of a quad
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
#pragma unroll
        for (int d = 1; d <= 2; d <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(~0u, mx0, d));
          mx1 = fmaxf(mx1, __shfl_xor_sync(~0u, mx1, d));
        }
        // a row that has seen no valid key keeps m = -1e30: alpha is 1 and
        // every masked p is exp2(-inf) = 0
        const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
        m0 = mx0;
        m1 = mx1;
        float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          sc[4 * j] = exp2f(sc[4 * j] - mx0);
          sc[4 * j + 1] = exp2f(sc[4 * j + 1] - mx0);
          sc[4 * j + 2] = exp2f(sc[4 * j + 2] - mx1);
          sc[4 * j + 3] = exp2f(sc[4 * j + 3] - mx1);
          sum0 += sc[4 * j] + sc[4 * j + 1];
          sum1 += sc[4 * j + 2] + sc[4 * j + 3];
        }
        l0 = l0 * a0 + sum0;   // l from the fp32 probabilities
        l1 = l1 * a1 + sum1;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          o[4 * j] *= a0;
          o[4 * j + 1] *= a0;
          o[4 * j + 2] *= a1;
          o[4 * j + 3] *= a1;
        }
        // O += P.V, 16 keys a step; P rounded to bf16 in registers
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) {
          const uint32_t a[4] = {pack_bf16(sc[8 * kk], sc[8 * kk + 1]),
                                 pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]),
                                 pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]),
                                 pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7])};
          mma_pv<HD>(o, a,
                     make_desc(v_s + s * C::kTileBytes + kk * 16 * 128,
                               kChunkBytes, 1024));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
      }
      mbar_arrive(empty0 + 8 * s);
    }

    // divide once, cast once; rows past Sq are not stored; a row with no
    // valid key (l = 0) writes 0
#pragma unroll
    for (int d = 1; d <= 2; d <<= 1) {
      l0 += __shfl_xor_sync(~0u, l0, d);
      l1 += __shfl_xor_sync(~0u, l1, d);
    }
    const float inv0 = l0 > 0.0f ? 1.0f / l0 : 0.0f;
    const float inv1 = l1 > 0.0f ? 1.0f / l1 : 0.0f;
    __nv_bfloat16* o_head = out + static_cast<size_t>(bh) * Sq * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int c = 8 * j + col0;
      if (row0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(o_head +
                                           static_cast<size_t>(row0) * HD + c) =
            __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (row0 + 8 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(
            o_head + static_cast<size_t>(row0 + 8) * HD + c) =
            __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

// ---- host side --------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call; it is reached through the
// runtime's entry-point lookup, so the library needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [depth][stride][hd] bf16 tensor, of whose `stride` rows the first `rows`
// are mapped, as a 3-d map of [128 rows][64 columns] boxes, 128-byte
// swizzled; rows past `rows` read as zeros.
inline bool make_map(CUtensorMap* map, const void* ptr, int depth, int rows,
                     int stride, int hd) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(depth)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(stride) * hd * 2};
  const cuuint32_t box[3] = {64, 128, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int K, int Sq, int Sk, int sk_valid,
                   int q_offset, float scale, int causal,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B * H, Sq, Sq, HD) ||
      !make_map(&tk, k, B * K, sk_valid, Sk, HD) ||
      !make_map(&tv, v, B * K, sk_valid, Sk, HD))
    return cudaErrorInvalidValue;
  const int smem = Cfg<HD>::kSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long n_qt = (Sq + kRows - 1) / kRows;
  wgmma_kernel<HD><<<static_cast<unsigned>(n_qt * B * H), kThreads, smem,
                     stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(out),
                               B, H, K, Sq, sk_valid, q_offset,
                               scale * 1.4426950408889634f, causal);
  return cudaGetLastError();
}

}  // namespace wg
