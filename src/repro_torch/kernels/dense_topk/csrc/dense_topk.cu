// Dense-retrieval scoring with a fused top-k, for Hopper (sm_90a).
//
// Replaces the TPU kernel `dense_topk` of the reference package
// (src/repro/kernels/dense_topk/kernel.py:96, pallas_call at :116).  It
// computes the same function: scores q . c^T summed in fp32 on the FMA
// units (no TF32, no tensor cores; bf16 inputs are converted on load),
// and per query row the k best (score, doc index) pairs under the total
// order "score descending, then doc index ascending".  Empty slots are
// (NEG_INF = -1e30, IDX_PAD = 2^30), so they can never win.
//
// What bounds it on an H100: at the retrieval shape of the Table 2
// experiment (Q = 53, N = 39,600, d = 128, fp32) the corpus is 20.3 MB,
// read once in 6 us at 3.35 TB/s, and the products are 0.54 GFLOP of
// fp32 FMA, 8 us at 67 TFLOP/s: the FMA rate bounds it.  The design
// spreads that work over every SM and keeps the selection small:
//
// 1. Stage 1, grid (ceil(Q / 16), S): a block takes 16 queries over one
//    contiguous split of the corpus (`plan` in kernel.py picks S from the
//    SM count) and walks it in steps of 128 docs x 32 dims, so any width
//    fits.  Eight warps compute; warp w owns queries 2w and 2w + 1, lane
//    l scores docs l, l + 32, l + 64, l + 96 of the step, 2 x 4 sums in
//    registers from 16-byte shared-memory reads.  Every sum runs over d
//    in ascending order from 0 whatever the doc's position, so two
//    identical docs get bit-identical scores.
//    - fp32 rows of 16-byte multiples (`dense_topk_tma_kernel`): a ninth
//      warp is the producer, one thread of which keeps up to ns - 1 steps
//      of TMA loads in flight (the corpus box and the query box, 128-byte
//      swizzled so that reads of eight rows hit eight bank groups); each
//      consumer warp waits on its step's "full" barrier and releases the
//      stage on its "empty" one, at its own pace: no block-wide barrier
//      in the loop.
//    - otherwise (`dense_topk_select_kernel`: bf16, odd widths): two
//      stages, the next step's loads in registers during this step's
//      products, one block barrier a step; neighbouring threads load
//      neighbouring elements.
// 2. Threshold filter.  Each query row holds, in k_pad + 256 slots (k_pad
//    the next power of two >= k), its best k so far in no order and then
//    candidates: a scored doc is appended (__ballot_sync/__popc, no
//    atomics: the warp owns its rows) only if it is better than the
//    threshold, the k-th best held.  When the next tile might not fit,
//    `select_top` keeps exactly the best k: the warp finds the k-th best
//    score key bit by bit from warp-wide counts, resolves entries tied at
//    that key by index the same way, compacts, and the threshold becomes
//    that k-th entry.  No sorting until the end.
//    Why dropping is exact: k held entries are at or above the threshold,
//    so a doc not better than it has k better ones and is not in the
//    split's top k.  A split visits its docs in ascending index and every
//    held entry comes from an earlier tile, so a later doc whose score
//    equals the threshold always loses the tie: "score > threshold" alone
//    would be exact but for empty slots.  The test is the full
//    `better(s, doc, thr_v, thr_i)` all the same, which lets every real
//    doc past an empty threshold (NEG_INF, IDX_PAD) and stays exact if
//    tiles were ever visited out of order.
//    At the split's end: with S = 1 the warp sorts its row's best k
//    (bitonic, in registers) and writes the result; otherwise it writes
//    them in no order.
// 3. Stage 2, `dense_topk_merge_kernel`, one block per query (skipped
//    when S = 1): the same exact selection, block-wide, over the S x k
//    candidates, then one bitonic sort of the k winners.  Ties, across
//    splits too, come out lower index first.
// 4. k above 1,024 (the large-k path, `dense_topk_large_*`): a row's
//    k_pad + 256 slots no longer fit a block.  Stage 1 runs in score mode
//    and writes a query chunk's scores to a buffer in device memory (the
//    wrapper's `plan` keeps a chunk's buffer under 1 GiB); an exact radix
//    select over the same order-preserving keys finds each row's k-th key,
//    compacts the docs above it and the lowest-index docs tied at it in
//    ascending doc order, and a bitonic sort orders the k winners.  Same
//    total order, same exact ties, any k <= N.
//
// Shared memory: stage 1 on the TMA path 1 KB (alignment) + ns x 18,448 B
// (stages and their barriers) + 16 x (k_pad + 256) x 8 B of rows, 137 KB
// at k = 200 with ns = 4; stage 2 12 B per candidate + 8 x k_pad B.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;        // 8 warps
constexpr int kBQ = 16;              // queries per block: 2 per warp
constexpr int kBN = 128;             // docs per tile: 4 per lane
constexpr int kBK = 32;              // dims per chunk
constexpr int kLd = kBK + 4;         // tile row stride: 144 B, 16-B aligned
constexpr int kCand = 256;           // candidate slots per query row
constexpr int kMergeThreads = 256;
constexpr int kMaxSmem = 232448;     // bytes a block may use on sm_90
constexpr int kStageFloats = (kBN + kBQ) * kLd;     // a register-path stage
constexpr int kTmaStageFloats = (kBN + kBQ) * kBK;  // a TMA stage, 18,432 B
constexpr int kMaxStages = 6;
constexpr float kNegInf = -1e30f;
constexpr int kIdxPad = 1 << 30;     // > any real doc index
constexpr int kCPer = kBN * kBK / kThreads;  // corpus values a thread stages
constexpr int kQPer = kBQ * kBK / kThreads;  // query values a thread stages

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

// Total order of the results: higher score first, then lower index.
__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// Compare-exchange of slots lo < hi: the better entry goes to lo when
// best_first, to hi otherwise.
__device__ __forceinline__ void cmp_swap(float* v, int* ix, int lo, int hi,
                                         bool best_first) {
  const float va = v[lo], vb = v[hi];
  const int ia = ix[lo], ib = ix[hi];
  const bool swap = best_first ? better(vb, ib, va, ia)
                               : better(va, ia, vb, ib);
  if (swap) {
    v[lo] = vb; v[hi] = va;
    ix[lo] = ib; ix[hi] = ia;
  }
}

// Slot paired with compare-exchange number t at a power-of-two stride.
__device__ __forceinline__ int lower_slot(int t, int stride) {
  return ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
}

// Compare-exchange across lanes at a stride < 32: this lane's entry and
// its partner's (lane ^ stride); the lane keeps the better of the two if
// want_better, else the worse.
__device__ __forceinline__ void lane_exchange(float& v, int& ix, int stride,
                                              bool want_better) {
  const float ov = __shfl_xor_sync(0xffffffffu, v, stride);
  const int oi = __shfl_xor_sync(0xffffffffu, ix, stride);
  if (want_better == better(ov, oi, v, ix)) {
    v = ov;
    ix = oi;
  }
}

// One warp sorts 32 * R entries best first, entry r * 32 + lane in this
// lane's registers v[r], ix[r]: strides >= 32 within a lane, shorter
// ones across lanes.
template <int R>
__device__ __forceinline__ void sort_regs(float (&v)[R], int (&ix)[R],
                                          int lane) {
#pragma unroll
  for (int size = 2; size <= 32 * R; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {
        const int s = stride / 32;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r & s) continue;
          const bool up = ((r * 32) & size) == 0;
          const bool swap = up ? better(v[r | s], ix[r | s], v[r], ix[r])
                               : better(v[r], ix[r], v[r | s], ix[r | s]);
          if (swap) {
            const float tv = v[r]; v[r] = v[r | s]; v[r | s] = tv;
            const int ti = ix[r]; ix[r] = ix[r | s]; ix[r | s] = ti;
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int p = r * 32 + lane;
          lane_exchange(v[r], ix[r], stride,
                        ((p & stride) == 0) == ((p & size) == 0));
        }
      }
    }
  }
}

// One warp sorts a bitonic sequence of 32 * R entries best first, entry
// r * 32 + lane in v[r], ix[r]; with R = 1 the sequence may be the first
// n < 32 entries, the rest empty.
template <int R>
__device__ __forceinline__ void merge_regs(float (&v)[R], int (&ix)[R],
                                           int n, int lane) {
#pragma unroll
  for (int stride = 16 * R; stride >= 32; stride >>= 1) {
    const int s = stride / 32;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r & s) continue;
      if (better(v[r | s], ix[r | s], v[r], ix[r])) {
        const float tv = v[r]; v[r] = v[r | s]; v[r | s] = tv;
        const int ti = ix[r]; ix[r] = ix[r | s]; ix[r | s] = ti;
      }
    }
  }
#pragma unroll
  for (int stride = R > 1 ? 16 : min(n, 32) >> 1; stride > 0; stride >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      lane_exchange(v[r], ix[r], stride, (lane & stride) == 0);
    }
  }
}

// merge_regs on a run of n <= 32 * R entries in shared memory.
template <int R>
__device__ __forceinline__ void merge_run(float* v, int* ix, int n,
                                          int lane) {
  float rv[R];
  int ri[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = r * 32 + lane;
    rv[r] = p < n ? v[p] : kNegInf;
    ri[r] = p < n ? ix[p] : kIdxPad;
  }
  merge_regs<R>(rv, ri, n, lane);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = r * 32 + lane;
    if (p < n) {
      v[p] = rv[r];
      ix[p] = ri[r];
    }
  }
}

// One warp sorts a bitonic sequence of n (a power of two) entries in
// shared memory best first: strides >= 256 in shared memory, then each
// run of up to 256 in registers.
__device__ void warp_merge(float* v, int* ix, int n, int lane) {
  for (int stride = n >> 1; stride >= 256; stride >>= 1) {
    for (int t = lane; t < n / 2; t += 32) {
      const int lo = lower_slot(t, stride);
      cmp_swap(v, ix, lo, lo + stride, true);
    }
    __syncwarp();
  }
  const int run = min(n, 256);
  for (int base = 0; base < n; base += run) {
    if (run == 256) {
      merge_run<8>(v + base, ix + base, run, lane);
    } else if (run == 128) {
      merge_run<4>(v + base, ix + base, run, lane);
    } else if (run == 64) {
      merge_run<2>(v + base, ix + base, run, lane);
    } else {
      merge_run<1>(v + base, ix + base, run, lane);
    }
  }
  __syncwarp();
}

// sort_regs on a run of n <= 32 * R entries in shared memory.
template <int R>
__device__ __forceinline__ void sort_run(float* v, int* ix, int n,
                                         int lane) {
  float rv[R];
  int ri[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = r * 32 + lane;
    rv[r] = p < n ? v[p] : kNegInf;
    ri[r] = p < n ? ix[p] : kIdxPad;
  }
  sort_regs<R>(rv, ri, lane);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int p = r * 32 + lane;
    if (p < n) {
      v[p] = rv[r];
      ix[p] = ri[r];
    }
  }
}

// One warp sorts n (a power of two) entries in shared memory best first:
// runs of up to 256 in registers, then sorted runs merged pairwise (the
// second reversed, so that the pair is bitonic).
__device__ void warp_sort(float* v, int* ix, int n, int lane) {
  const int run = min(n, 256);
  for (int base = 0; base < n; base += run) {
    if (run == 256) {
      sort_run<8>(v + base, ix + base, run, lane);
    } else if (run == 128) {
      sort_run<4>(v + base, ix + base, run, lane);
    } else if (run == 64) {
      sort_run<2>(v + base, ix + base, run, lane);
    } else {
      sort_run<1>(v + base, ix + base, run, lane);
    }
  }
  __syncwarp();
  for (int size = 2 * run; size <= n; size <<= 1) {
    for (int base = 0; base < n; base += size) {
      float* bv = v + base + size / 2;
      int* bi = ix + base + size / 2;
      for (int t = lane; t < size / 4; t += 32) {
        const int u = size / 2 - 1 - t;
        const float tv = bv[t]; bv[t] = bv[u]; bv[u] = tv;
        const int ti = bi[t]; bi[t] = bi[u]; bi[u] = ti;
      }
      __syncwarp();
      warp_merge(v + base, ix + base, size, lane);
    }
  }
}

// Order-preserving key of a score: a larger score has a larger key, and
// -0 and +0 share one, as they compare equal.
__device__ __forceinline__ unsigned score_key(float s) {
  const unsigned b = __float_as_uint(s + 0.0f);
  return b ^ ((b >> 31) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ float key_score(unsigned u) {
  return __uint_as_float(u ^ ((u >> 31) ? 0x80000000u : 0xffffffffu));
}

// Keeps the k best of a row's m > k entries (real docs, in no order) in
// its first k slots, and returns the k-th best of them, the new
// threshold, in (thr_v, thr_i).  The warp finds the k-th best score key
// V bit by bit (the largest V with at least k keys >= V), then, if more
// entries share V than the k - g slots left after the g better ones,
// the (k - g)-th smallest index among them the same way; then compacts.
// KR >= ceil(m / 32): keys held a lane.
template <int KR>
__device__ void select_top(float* v, int* ix, int m, int k, int lane,
                           float& thr_v, int& thr_i) {
  const unsigned below = (1u << lane) - 1;
  unsigned key[KR];
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    const int t = r * 32 + lane;
    key[r] = t < m ? score_key(v[t]) : 0u;   // 0: below any real key
  }
  unsigned kv = 0;
  for (int bit = 31; bit >= 0; --bit) {
    const unsigned cand = kv | (1u << bit);
    int c0 = 0, c1 = 0;   // two chains, so the adds overlap
#pragma unroll
    for (int r = 0; r < KR; r += 2) {
      c0 += key[r] >= cand;
      if (r + 1 < KR) c1 += key[r + 1] >= cand;
    }
    if (__reduce_add_sync(0xffffffffu, c0 + c1) >= k) kv = cand;
  }
  int g = 0, e = 0, last = -1;
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    const int t = r * 32 + lane;
    g += key[r] > kv;
    if (t < m && key[r] == kv) {
      ++e;
      last = max(last, ix[t]);
    }
  }
  g = __reduce_add_sync(0xffffffffu, g);
  e = __reduce_add_sync(0xffffffffu, e);
  // the tied entries kept are those with index <= cut
  int cut = __reduce_max_sync(0xffffffffu, last);
  if (e > k - g) {
    int x = 0;   // the largest x with fewer than k - g tied indices < x
    for (int bit = 30; bit >= 0; --bit) {
      const int cand = x | (1 << bit);
      int c = 0;
#pragma unroll
      for (int r = 0; r < KR; ++r) {
        const int t = r * 32 + lane;
        c += t < m && key[r] == kv && ix[t] < cand;
      }
      if (__reduce_add_sync(0xffffffffu, c) < k - g) x = cand;
    }
    cut = x;
  }
  int out = 0;
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    const int t = r * 32 + lane;
    const bool in = t < m;
    const float sv = in ? v[t] : 0.0f;
    const int si = in ? ix[t] : 0;
    const bool keep = in && (key[r] > kv || (key[r] == kv && si <= cut));
    const unsigned bal = __ballot_sync(0xffffffffu, keep);
    __syncwarp();            // this run read before any slot is rewritten
    if (keep) {
      const int at = out + __popc(bal & below);
      v[at] = sv;
      ix[at] = si;
    }
    out += __popc(bal);
    __syncwarp();
  }
  thr_v = key_score(kv);
  thr_i = cut;
}

// select_top for a row array of cap = k_pad + kCand slots.
__device__ void select_row(float* v, int* ix, int m, int k, int k_pad,
                           int lane, float& thr_v, int& thr_i) {
  if (k_pad <= 256) {
    select_top<16>(v, ix, m, k, lane, thr_v, thr_i);
  } else if (k_pad == 512) {
    select_top<24>(v, ix, m, k, lane, thr_v, thr_i);
  } else {
    select_top<40>(v, ix, m, k, lane, thr_v, thr_i);
  }
}

// ---- loading a step: a corpus tile [doc0, doc0 + kBN) x [dim0, dim0 + kBK)
// and the matching kBQ x kBK query block ----------------------------------

// The register path: for inputs TMA cannot take (bf16, rows not 16-byte
// aligned).  load_regs issues the loads before a step's products and
// store_regs converts them into the other stage after them.  Docs past
// doc_end, queries past n_q and dims past d are zeros.
template <typename T>
__device__ __forceinline__ void load_regs(const T* __restrict__ q,
                                          const T* __restrict__ c, int n_q,
                                          int q0, int doc0, int doc_end,
                                          int dim0, int d, T (&cr)[kCPer],
                                          T (&qr)[kQPer]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kQPer; ++i) {
    const int e = i * kThreads + tid, r = e / kBK, j = dim0 + e % kBK;
    qr[i] = (q0 + r < n_q && j < d) ? q[static_cast<size_t>(q0 + r) * d + j]
                                    : zero<T>();
  }
#pragma unroll
  for (int i = 0; i < kCPer; ++i) {
    const int e = i * kThreads + tid, r = e / kBK, j = dim0 + e % kBK;
    const int doc = doc0 + r;
    cr[i] = (doc < doc_end && j < d) ? c[static_cast<size_t>(doc) * d + j]
                                     : zero<T>();
  }
}

template <typename T>
__device__ __forceinline__ void store_regs(float* stage,
                                           const T (&cr)[kCPer],
                                           const T (&qr)[kQPer]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kCPer; ++i) {
    const int e = i * kThreads + tid;
    stage[(e / kBK) * kLd + e % kBK] = to_f32(cr[i]);
  }
#pragma unroll
  for (int i = 0; i < kQPer; ++i) {
    const int e = i * kThreads + tid;
    stage[(kBN + e / kBK) * kLd + e % kBK] = to_f32(qr[i]);
  }
}

// The fp32 path: TMA boxes of 32 floats x rows, 128-byte swizzled (the
// 16-byte chunk j of row r lands at chunk j ^ (r % 8)), so that eight
// lanes reading one chunk of eight rows hit eight bank groups.
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

// One box of a 2-d tensor map into shared memory, completing on `bar`;
// rows and columns past the tensor's edge read as zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// Four floats from column col (a multiple of 4) of a stage's row: the
// register path's padded rows, or the TMA path's swizzled ones.
template <bool kSwz>
__device__ __forceinline__ float4 ld4(const float* base, int row, int col) {
  if constexpr (kSwz) {
    return *reinterpret_cast<const float4*>(
        base + row * kBK + (((col >> 2) ^ (row & 7)) << 2));
  } else {
    return *reinterpret_cast<const float4*>(base + row * kLd + col);
  }
}

// ---- what every consumer warp does ----------------------------------------

// The warp's two query rows r0, r0 + 1 of the block and where they stand:
// the k-th best held so far (the filter's threshold) and the number of
// entries held, its best k in no order and then candidates, in cap slots.
struct Rows {
  float thr_v[2] = {kNegInf, kNegInf};
  int thr_i[2] = {kIdxPad, kIdxPad};
  int have[2] = {0, 0};
  float acc[2][4];
};

// A step's products: lane l's docs l, l + 32, l + 64, l + 96 against the
// two rows, summed over the chunk's dims in ascending order.
template <bool kSwz>
__device__ __forceinline__ void products(const float* cb, const float* qb,
                                         int r0, int lane, Rows& w) {
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 4) {
    const float4 a0 = ld4<kSwz>(qb, r0, kk);
    const float4 a1 = ld4<kSwz>(qb, r0 + 1, kk);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 b = ld4<kSwz>(cb, lane + 32 * j, kk);
      w.acc[0][j] = fmaf(a0.x, b.x, w.acc[0][j]);
      w.acc[0][j] = fmaf(a0.y, b.y, w.acc[0][j]);
      w.acc[0][j] = fmaf(a0.z, b.z, w.acc[0][j]);
      w.acc[0][j] = fmaf(a0.w, b.w, w.acc[0][j]);
      w.acc[1][j] = fmaf(a1.x, b.x, w.acc[1][j]);
      w.acc[1][j] = fmaf(a1.y, b.y, w.acc[1][j]);
      w.acc[1][j] = fmaf(a1.z, b.z, w.acc[1][j]);
      w.acc[1][j] = fmaf(a1.w, b.w, w.acc[1][j]);
    }
  }
}

// After a tile's last chunk: each row appends the docs better than its
// threshold (ballot, no atomics: the warp owns its rows), and keeps only
// its best k when the next tile might not fit.
__device__ __forceinline__ void filter_tile(Rows& w, float* rows_v,
                                            int* rows_i, int cap, int r0,
                                            int q0, int n_q, int doc0,
                                            int hi, int k, int k_pad,
                                            int lane) {
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (q0 + r0 + r >= n_q) continue;               // warp-uniform
    float* rv = rows_v + (r0 + r) * cap;
    int* ri = rows_i + (r0 + r) * cap;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int doc = doc0 + lane + 32 * j;
      const bool in =
          doc < hi && better(w.acc[r][j], doc, w.thr_v[r], w.thr_i[r]);
      const unsigned m = __ballot_sync(0xffffffffu, in);
      if (in) {
        const int at = w.have[r] + __popc(m & below);
        rv[at] = w.acc[r][j];
        ri[at] = doc;
      }
      w.have[r] += __popc(m);
    }
    if (w.have[r] > cap - kBN) {
      __syncwarp();
      select_row(rv, ri, w.have[r], k, k_pad, lane, w.thr_v[r], w.thr_i[r]);
      w.have[r] = k;
    }
  }
}

// After the split: each row's best k, padded with empty slots; sorted
// when there is one split (the result), in no order otherwise.
__device__ __forceinline__ void write_rows(Rows& w, float* rows_v,
                                           int* rows_i, int cap, int r0,
                                           int q0, int n_q, int k, int k_pad,
                                           float* __restrict__ out_v,
                                           int* __restrict__ out_i,
                                           int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + r;
    if (q0 + row >= n_q) continue;
    float* rv = rows_v + row * cap;
    int* ri = rows_i + row * cap;
    __syncwarp();
    if (w.have[r] > k) {
      select_row(rv, ri, w.have[r], k, k_pad, lane, w.thr_v[r], w.thr_i[r]);
      w.have[r] = k;
    }
    for (int t = w.have[r] + lane; t < k_pad; t += 32) {
      rv[t] = kNegInf;
      ri[t] = kIdxPad;
    }
    __syncwarp();
    if (gridDim.y == 1) warp_sort(rv, ri, k_pad, lane);
    const size_t out =
        (static_cast<size_t>(q0 + row) * gridDim.y + blockIdx.y) * k;
    for (int t = lane; t < k; t += 32) {
      out_v[out + t] = rv[t];
      out_i[out + t] = ri[t];
    }
  }
}

// The large-k path's stage 1: a tile's scores into the [n_q, n_docs]
// buffer, lane l writing docs l, l + 32, l + 64, l + 96 (coalesced).
__device__ __forceinline__ void write_scores(const Rows& w,
                                             float* __restrict__ scores,
                                             int r0, int q0, int n_q,
                                             int n_docs, int doc0, int hi,
                                             int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (q0 + r0 + r >= n_q) continue;
    float* out = scores + static_cast<size_t>(q0 + r0 + r) * n_docs;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int doc = doc0 + lane + 32 * j;
      if (doc < hi) out[doc] = w.acc[r][j];
    }
  }
}

// Docs [lo, hi) of split blockIdx.y.
__device__ __forceinline__ void split_range(int n_docs, int per_split,
                                            int& lo, int& hi) {
  lo = static_cast<int>(min(static_cast<long long>(n_docs),
                            static_cast<long long>(blockIdx.y) * per_split));
  hi = static_cast<int>(min(static_cast<long long>(n_docs),
                            static_cast<long long>(lo) + per_split));
}

// Stage 1 on the register path: 8 warps, two stages, the next step's
// loads in registers during this step's products, one barrier a step.
template <typename T, bool kScores>
__global__ void __launch_bounds__(kThreads)
dense_topk_select_kernel(const T* __restrict__ q, const T* __restrict__ c,
                         float* __restrict__ out_v, int* __restrict__ out_i,
                         int n_q, int n_docs, int d, int k, int k_pad,
                         int per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* stages = reinterpret_cast<float*>(smem);       // [2][kStageFloats]
  const int cap = kScores ? 0 : k_pad + kCand;
  float* rows_v = stages + 2 * kStageFloats;            // [kBQ][cap]
  int* rows_i = reinterpret_cast<int*>(rows_v + kBQ * cap);

  const int lane = threadIdx.x % 32, r0 = 2 * (threadIdx.x / 32);
  const int q0 = blockIdx.x * kBQ;
  int lo, hi;
  split_range(n_docs, per_split, lo, hi);
  // step s: corpus tile s / n_chunks, dims chunk s % n_chunks
  const int n_chunks = (d + kBK - 1) / kBK;
  const int n_steps = (hi - lo + kBN - 1) / kBN * n_chunks;
  Rows w;
  T cr[kCPer], qr[kQPer];
  if (n_steps > 0) {
    load_regs<T>(q, c, n_q, q0, lo, hi, 0, d, cr, qr);
    store_regs<T>(stages, cr, qr);
  }
  for (int st = 0; st < n_steps; ++st) {
    const int tile = st / n_chunks, ch = st - tile * n_chunks;
    const int nt = (st + 1) / n_chunks;
    __syncthreads();           // step st stored; stage (st + 1) % 2 is free
    if (st + 1 < n_steps) {
      load_regs<T>(q, c, n_q, q0, lo + nt * kBN, hi,
                   (st + 1 - nt * n_chunks) * kBK, d, cr, qr);
    }
    if (ch == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) w.acc[0][j] = w.acc[1][j] = 0.0f;
    }
    const float* cb = stages + (st % 2) * kStageFloats;
    products<false>(cb, cb + kBN * kLd, r0, lane, w);
    if (ch == n_chunks - 1) {
      if constexpr (kScores) {
        write_scores(w, out_v, r0, q0, n_q, n_docs, lo + tile * kBN, hi,
                     lane);
      } else {
        filter_tile(w, rows_v, rows_i, cap, r0, q0, n_q, lo + tile * kBN,
                    hi, k, k_pad, lane);
      }
    }
    if (st + 1 < n_steps) {
      store_regs<T>(stages + ((st + 1) % 2) * kStageFloats, cr, qr);
    }
  }
  if constexpr (!kScores) {
    write_rows(w, rows_v, rows_i, cap, r0, q0, n_q, k, k_pad, out_v, out_i,
               lane);
  }
}

// Stage 1 on the fp32 path: warp 8 is the producer, one thread of which
// keeps ns - 1 steps of TMA loads in flight; the 8 consumer warps wait
// on a stage's "full" barrier and release it on its "empty" one, each at
// its own pace, with no block-wide barrier in the loop.
template <bool kScores>
__global__ void __launch_bounds__(kThreads + 32, 1)
dense_topk_tma_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_c,
                      float* __restrict__ out_v, int* __restrict__ out_i,
                      int n_q, int n_docs, int d, int k, int k_pad,
                      int per_split, int ns) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // 128-byte swizzled boxes want 1024-byte aligned stages
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  float* stages = reinterpret_cast<float*>(smem);       // [ns][kTmaStageFloats]
  const int cap = kScores ? 0 : k_pad + kCand;
  float* rows_v = stages + ns * kTmaStageFloats;        // [kBQ][cap]
  int* rows_i = reinterpret_cast<int*>(rows_v + kBQ * cap);
  const uint32_t full0 = smem_u32(rows_i + kBQ * cap);  // ns full, ns empty
  const uint32_t empty0 = full0 + 8 * ns;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kBQ;
  int lo, hi;
  split_range(n_docs, per_split, lo, hi);
  const int n_chunks = (d + kBK - 1) / kBK;
  const int n_steps = (hi - lo + kBN - 1) / kBN * n_chunks;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kThreads / 32) {
    // ---- producer ---------------------------------------------------------
    if (lane == 0) {
      for (int st = 0; st < n_steps; ++st) {
        const int s = st % ns, tile = st / n_chunks;
        if (st >= ns) mbar_wait(empty0 + 8 * s, (st / ns - 1) & 1);
        mbar_expect_tx(full0 + 8 * s, kTmaStageFloats * 4);
        const uint32_t dst = smem_u32(stages + s * kTmaStageFloats);
        const int dim0 = (st - tile * n_chunks) * kBK;
        tma_load_2d(dst, &tm_c, full0 + 8 * s, dim0, lo + tile * kBN);
        tma_load_2d(dst + kBN * kBK * 4, &tm_q, full0 + 8 * s, dim0, q0);
      }
    }
    return;
  }
  // ---- consumers ------------------------------------------------------------
  const int r0 = 2 * warp;
  Rows w;
  for (int st = 0; st < n_steps; ++st) {
    const int s = st % ns;
    const int tile = st / n_chunks, ch = st - tile * n_chunks;
    mbar_wait(full0 + 8 * s, (st / ns) & 1);
    if (ch == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) w.acc[0][j] = w.acc[1][j] = 0.0f;
    }
    const float* cb = stages + s * kTmaStageFloats;
    products<true>(cb, cb + kBN * kBK, r0, lane, w);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
    if (ch == n_chunks - 1) {
      if constexpr (kScores) {
        write_scores(w, out_v, r0, q0, n_q, n_docs, lo + tile * kBN, hi,
                     lane);
      } else {
        filter_tile(w, rows_v, rows_i, cap, r0, q0, n_q, lo + tile * kBN,
                    hi, k, k_pad, lane);
      }
    }
  }
  if constexpr (!kScores) {
    write_rows(w, rows_v, rows_i, cap, r0, q0, n_q, k, k_pad, out_v, out_i,
               lane);
  }
}

// Block-wide sum of one int a thread; `red` holds a slot a warp.
__device__ __forceinline__ int block_sum(int x, int* red) {
  x = __reduce_add_sync(0xffffffffu, x);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kMergeThreads / 32; ++w) total += red[w];
  __syncthreads();
  return total;
}

__device__ __forceinline__ int block_max(int x, int* red) {
  x = __reduce_max_sync(0xffffffffu, x);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  int total = red[0];
#pragma unroll
  for (int w = 1; w < kMergeThreads / 32; ++w) total = max(total, red[w]);
  __syncthreads();
  return total;
}

// The block sorts n (a power of two) entries in shared memory best first.
__device__ void block_sort(float* v, int* ix, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < n / 2; t += kMergeThreads) {
        const int lo = lower_slot(t, stride);
        cmp_swap(v, ix, lo, lo + stride, (lo & size) == 0);
      }
      __syncthreads();
    }
  }
}

// Stage 2, one block a query: the best k of the splits' m = splits * k
// candidates (each split's best k, in no order; empty slots carry
// IDX_PAD), found as select_top finds them but block-wide, then sorted
// once and written.
__global__ void __launch_bounds__(kMergeThreads)
dense_topk_merge_kernel(const float* __restrict__ part_v,
                        const int* __restrict__ part_i,
                        float* __restrict__ vals, int* __restrict__ idxs,
                        int splits, int k, int k_pad) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m = splits * k;
  float* v = reinterpret_cast<float*>(smem);             // [m]
  int* ix = reinterpret_cast<int*>(v + m);               // [m]
  unsigned* key = reinterpret_cast<unsigned*>(ix + m);   // [m]
  float* top_v = reinterpret_cast<float*>(key + m);      // [k_pad]
  int* top_i = reinterpret_cast<int*>(top_v + k_pad);    // [k_pad]
  int* red = top_i + k_pad;                              // [warps + 1]
  const size_t row = blockIdx.x;
  for (int t = threadIdx.x; t < m; t += kMergeThreads) {
    const float sv = part_v[row * m + t];
    const int si = part_i[row * m + t];
    v[t] = sv;
    ix[t] = si;
    key[t] = si == kIdxPad ? 0u : score_key(sv);   // empty: below any doc
  }
  for (int t = threadIdx.x; t < k_pad; t += kMergeThreads) {
    top_v[t] = kNegInf;
    top_i[t] = kIdxPad;
  }
  if (threadIdx.x == 0) red[kMergeThreads / 32] = 0;
  __syncthreads();
  unsigned kv = 0;
  for (int bit = 31; bit >= 0; --bit) {
    const unsigned cand = kv | (1u << bit);
    int c = 0;
    for (int t = threadIdx.x; t < m; t += kMergeThreads) c += key[t] >= cand;
    if (block_sum(c, red) >= k) kv = cand;
  }
  int g = 0, e = 0, last = -1;
  for (int t = threadIdx.x; t < m; t += kMergeThreads) {
    g += key[t] > kv;
    if (key[t] == kv) {
      ++e;
      last = max(last, ix[t]);
    }
  }
  g = block_sum(g, red);
  e = block_sum(e, red);
  int cut = block_max(last, red);
  if (e > k - g) {
    int x = 0;   // the largest x with fewer than k - g tied indices < x
    for (int bit = 30; bit >= 0; --bit) {
      const int cand = x | (1 << bit);
      int c = 0;
      for (int t = threadIdx.x; t < m; t += kMergeThreads) {
        c += key[t] == kv && ix[t] < cand;
      }
      if (block_sum(c, red) < k - g) x = cand;
    }
    cut = x;
  }
  int* n_top = red + kMergeThreads / 32;
  for (int t = threadIdx.x; t < m; t += kMergeThreads) {
    if (key[t] > kv || (key[t] == kv && ix[t] <= cut)) {
      const int at = atomicAdd(n_top, 1);
      top_v[at] = v[t];
      top_i[at] = ix[t];
    }
  }
  __syncthreads();
  block_sort(top_v, top_i, k_pad);
  for (int t = threadIdx.x; t < k; t += kMergeThreads) {
    vals[row * k + t] = top_v[t];
    idxs[row * k + t] = top_i[t];
  }
}

// ---- the large-k path: exact radix select over a score buffer ------------
//
// For k above what a row's k_pad + 256 slots in shared memory hold, stage 1
// (in score mode) writes a query chunk's scores to a buffer, and each row's
// k best are found by an exact radix select over the order-preserving
// score keys, 8 bits a pass from the top:
// 1. `topk_hist_kernel`, 4 launches: pass p histograms digit p of the keys
//    whose higher digits equal the k-th key's so far, per slice of kSlice
//    docs (per-warp histograms in shared memory), summed into the row's
//    [4][256] counts in device memory by integer atomics, so the counts do
//    not depend on the order.  Every block first replays the earlier
//    passes' counts (`resolve`) to know those digits.
// 2. `topk_count_kernel`: with the k-th key V known, each slice counts its
//    keys above V and equal to V.
// 3. `topk_compact_kernel`: of the keys equal to V, the rem lowest indices
//    win (rem = k minus the keys above V).  A doc's place among the
//    winners is (keys above V before it) + min(keys equal to V before it,
//    rem), from the slices' counts and a block scan, so the winners land
//    in ascending doc order with no atomics.
// 4. `topk_sort_local_kernel` and `topk_sort_step_kernel`: a bitonic sort of
//    the k_pad winner slots (empty slots: key 0, IDX_PAD) by key, then
//    index: strides below kSortChunk in shared memory, longer ones one
//    launch each; the last launch writes the values and indices.
constexpr int kSelThreads = 256;
constexpr int kSlice = 8192;           // docs a select block walks
constexpr int kSortChunk = 8192;       // entries a sort block holds
constexpr int kSortThreads = 1024;

__device__ __forceinline__ bool key_better(unsigned ka, int ia, unsigned kb,
                                           int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

// The warp replays `passes` passes of the row's counts hist[p][256]: the
// top digits of the k-th key (prefix) and how many keys with that prefix
// still have to be taken (rem >= 1).  All 32 lanes get the result.
__device__ void resolve(const unsigned* __restrict__ hist, int passes, int k,
                        unsigned& prefix, int& rem) {
  const int lane = threadIdx.x % 32;
  prefix = 0;
  rem = k;
  for (int p = 0; p < passes; ++p) {
    unsigned c[8], sum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {        // lane 0 holds the highest digits
      c[j] = hist[p * 256 + 255 - (lane * 8 + j)];
      sum += c[j];
    }
    unsigned incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    const unsigned need = static_cast<unsigned>(rem);
    const int src = __ffs(__ballot_sync(0xffffffffu, incl >= need)) - 1;
    int digit = 0;
    unsigned above = 0;
    if (lane == src) {
      unsigned run = incl - sum;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (run + c[j] >= need) {
          digit = 255 - (lane * 8 + j);
          above = run;
          break;
        }
        run += c[j];
      }
    }
    digit = __shfl_sync(0xffffffffu, digit, src);
    above = __shfl_sync(0xffffffffu, above, src);
    prefix = (prefix << 8) | static_cast<unsigned>(digit);
    rem -= static_cast<int>(above);
  }
}

// Grid (slices, rows).  Pass p of the radix select.
__global__ void __launch_bounds__(kSelThreads)
topk_hist_kernel(const float* __restrict__ scores, unsigned* __restrict__ hist,
                 int n_docs, int k, int pass) {
  __shared__ unsigned h[kSelThreads / 32][256];
  __shared__ unsigned s_prefix;
  const size_t row = blockIdx.y;
  unsigned* hrow = hist + row * 4 * 256;
  for (int t = threadIdx.x; t < kSelThreads / 32 * 256; t += kSelThreads) {
    (&h[0][0])[t] = 0;
  }
  if (threadIdx.x < 32) {
    unsigned prefix;
    int rem;
    resolve(hrow, pass, k, prefix, rem);
    if (threadIdx.x == 0) s_prefix = prefix;
  }
  __syncthreads();
  const unsigned prefix = s_prefix;
  const int shift = 24 - 8 * pass;
  const float* srow = scores + row * n_docs;
  const int lo = blockIdx.x * kSlice, hi = min(n_docs, lo + kSlice);
  unsigned* hw = h[threadIdx.x / 32];
  for (int t = lo + threadIdx.x; t < hi; t += kSelThreads) {
    const unsigned key = score_key(srow[t]);
    if (pass == 0 || (key >> (shift + 8)) == prefix) {
      atomicAdd(&hw[(key >> shift) & 255u], 1u);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < 256; b += kSelThreads) {
    unsigned sum = 0;
#pragma unroll
    for (int w = 0; w < kSelThreads / 32; ++w) sum += h[w][b];
    if (sum) atomicAdd(&hrow[pass * 256 + b], sum);
  }
}

// Block-wide sum of one unsigned a thread (kSelThreads threads); `red`
// holds a slot a warp.
__device__ __forceinline__ unsigned sel_sum(unsigned x, unsigned* red) {
  x = __reduce_add_sync(0xffffffffu, x);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  unsigned total = 0;
#pragma unroll
  for (int w = 0; w < kSelThreads / 32; ++w) total += red[w];
  __syncthreads();
  return total;
}

// Grid (slices, rows): keys above and equal to the k-th key V, per slice,
// into counts[row][slice][2].
__global__ void __launch_bounds__(kSelThreads)
topk_count_kernel(const float* __restrict__ scores,
                  const unsigned* __restrict__ hist, int* __restrict__ counts,
                  int n_docs, int k) {
  __shared__ unsigned s_v, red[kSelThreads / 32];
  const size_t row = blockIdx.y;
  if (threadIdx.x < 32) {
    unsigned v;
    int rem;
    resolve(hist + row * 4 * 256, 4, k, v, rem);
    if (threadIdx.x == 0) s_v = v;
  }
  __syncthreads();
  const unsigned v = s_v;
  const float* srow = scores + row * n_docs;
  const int lo = blockIdx.x * kSlice, hi = min(n_docs, lo + kSlice);
  unsigned gt = 0, eq = 0;
  for (int t = lo + threadIdx.x; t < hi; t += kSelThreads) {
    const unsigned key = score_key(srow[t]);
    gt += key > v;
    eq += key == v;
  }
  gt = sel_sum(gt, red);
  eq = sel_sum(eq, red);
  if (threadIdx.x == 0) {
    int* out = counts + (row * gridDim.x + blockIdx.x) * 2;
    out[0] = static_cast<int>(gt);
    out[1] = static_cast<int>(eq);
  }
}

// Grid (slices, rows): the row's k winners, in ascending doc order, into
// win_key / win_idx [row][k_pad] (slots k.. are left for the sort).
__global__ void __launch_bounds__(kSelThreads)
topk_compact_kernel(const float* __restrict__ scores,
                    const unsigned* __restrict__ hist,
                    const int* __restrict__ counts,
                    unsigned* __restrict__ win_key, int* __restrict__ win_idx,
                    int n_docs, int k, int k_pad) {
  __shared__ unsigned s_v, red[kSelThreads / 32];
  __shared__ int s_rem;
  const size_t row = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x < 32) {
    unsigned v;
    int rem;
    resolve(hist + row * 4 * 256, 4, k, v, rem);
    if (threadIdx.x == 0) {
      s_v = v;
      s_rem = rem;
    }
  }
  // keys above and equal to V in the earlier slices
  unsigned gt = 0, eq = 0;
  const int* crow = counts + row * gridDim.x * 2;
  for (int s = threadIdx.x; s < static_cast<int>(blockIdx.x);
       s += kSelThreads) {
    gt += crow[2 * s];
    eq += crow[2 * s + 1];
  }
  __syncthreads();
  gt = sel_sum(gt, red);
  eq = sel_sum(eq, red);
  const unsigned v = s_v;
  const int rem = s_rem;
  const float* srow = scores + row * n_docs;
  unsigned* okey = win_key + row * k_pad;
  int* oidx = win_idx + row * k_pad;
  const int lo = blockIdx.x * kSlice, hi = min(n_docs, lo + kSlice);
  const unsigned below = (1u << lane) - 1;
  for (int base = lo; base < hi; base += kSelThreads) {
    const int t = base + threadIdx.x;
    const unsigned key = t < hi ? score_key(srow[t]) : 0u;
    const bool is_gt = t < hi && key > v, is_eq = t < hi && key == v;
    // docs above / equal to V before this one in the block's step
    const unsigned bg = __ballot_sync(0xffffffffu, is_gt);
    const unsigned be = __ballot_sync(0xffffffffu, is_eq);
    if (lane == 0) red[warp] = (__popc(be) << 16) | __popc(bg);
    __syncthreads();
    unsigned before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kSelThreads / 32; ++w) {
      before += w < warp ? red[w] : 0u;
      total += red[w];
    }
    __syncthreads();
    const unsigned g = gt + (before & 0xffffu) + __popc(bg & below);
    const unsigned e = eq + (before >> 16) + __popc(be & below);
    if (is_gt || (is_eq && e < static_cast<unsigned>(rem))) {
      const unsigned at = g + min(e, static_cast<unsigned>(rem));
      okey[at] = key;
      oidx[at] = t;
    }
    gt += total & 0xffffu;
    eq += total >> 16;
  }
}

// Compare-exchange of winner slots lo < hi: the better entry to lo when
// best_first, to hi otherwise.
__device__ __forceinline__ void key_swap(unsigned* key, int* ix, int lo,
                                         int hi, bool best_first) {
  const unsigned ka = key[lo], kb = key[hi];
  const int ia = ix[lo], ib = ix[hi];
  if (best_first ? key_better(kb, ib, ka, ia) : key_better(ka, ia, kb, ib)) {
    key[lo] = kb;
    key[hi] = ka;
    ix[lo] = ib;
    ix[hi] = ia;
  }
}

// Grid (k_pad / chunk, rows), chunk = min(k_pad, kSortChunk).  size == 0:
// loads the winners (slots from k on empty) and sorts each chunk, the
// bitonic network's sizes 2..chunk; else the strides below chunk of the
// merge at `size`.  The direction of a pair is that of its global slot, so
// chunks alternate as the network needs.  `final`: the sorted rows go to
// vals / idxs [rows][k] instead of back to the buffer.
__global__ void __launch_bounds__(kSortThreads)
topk_sort_local_kernel(unsigned* __restrict__ win_key,
                       int* __restrict__ win_idx, float* __restrict__ vals,
                       int* __restrict__ idxs, int k, int k_pad, int size,
                       int final) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunk = min(k_pad, kSortChunk);
  unsigned* sk = reinterpret_cast<unsigned*>(smem);
  int* si = reinterpret_cast<int*>(sk + chunk);
  const size_t row = blockIdx.y;
  const int base = blockIdx.x * chunk;
  unsigned* gk = win_key + row * k_pad + base;
  int* gi = win_idx + row * k_pad + base;
  for (int t = threadIdx.x; t < chunk; t += kSortThreads) {
    const bool empty = size == 0 && base + t >= k;
    sk[t] = empty ? 0u : gk[t];
    si[t] = empty ? kIdxPad : gi[t];
  }
  __syncthreads();
  for (int sz = size == 0 ? 2 : size; sz <= (size == 0 ? chunk : size);
       sz <<= 1) {
    for (int stride = min(sz, chunk) >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < chunk / 2; t += kSortThreads) {
        const int lo = lower_slot(t, stride);
        key_swap(sk, si, lo, lo + stride, ((base + lo) & sz) == 0);
      }
      __syncthreads();
    }
  }
  if (final) {
    for (int t = threadIdx.x; t < chunk && base + t < k; t += kSortThreads) {
      vals[row * k + base + t] = key_score(sk[t]);
      idxs[row * k + base + t] = si[t];
    }
  } else {
    for (int t = threadIdx.x; t < chunk; t += kSortThreads) {
      gk[t] = sk[t];
      gi[t] = si[t];
    }
  }
}

// Grid (ceil(k_pad / 2 / 256), rows): one stride >= kSortChunk of the
// bitonic merge at `size`, in device memory.
__global__ void __launch_bounds__(256)
topk_sort_step_kernel(unsigned* __restrict__ win_key,
                      int* __restrict__ win_idx, int k_pad, int size,
                      int stride) {
  const int t = blockIdx.x * 256 + threadIdx.x;
  if (t >= k_pad / 2) return;
  const size_t row = blockIdx.y;
  const int lo = lower_slot(t, stride);
  key_swap(win_key + row * k_pad, win_idx + row * k_pad, lo, lo + stride,
           (lo & size) == 0);
}

// Lets `kernel` use all of a block's shared memory on `device`, once:
// `done` is the caller's record, one per kernel.
template <typename K>
cudaError_t allow_max_smem(K kernel, int device, bool (&done)[64]) {
  if (device < 64 && done[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && device < 64) done[device] = true;
  return err;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call; it is reached through the
// runtime's entry-point lookup, so the library needs no -lcuda.
EncodeTiled encode_tiled() {
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

// A [rows][cols] fp32 tensor as a 2-d map of [box_rows][32] boxes,
// 128-byte swizzled; what lies past its edges reads as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols,
              int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 4};
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Shared memory of stage 1 on each path: stages (and, for TMA, their
// barriers and 1 KB to align them) and kBQ rows of cap slots (none in
// score mode).
int tma_smem(int ns, int cap) {
  return 1024 + ns * (kTmaStageFloats * 4 + 16) + kBQ * cap * 8;
}

int regs_smem(int cap) { return 2 * kStageFloats * 4 + kBQ * cap * 8; }

// Stage 2's shared memory: value, index and key of each candidate, the
// k_pad winners, and the reductions' slots.
long long merge_smem(int splits, int k, int k_pad) {
  return 12LL * splits * k + 8LL * k_pad + 4 * (kMergeThreads / 32 + 1);
}

// Makes `device` current only where it is not: the check is cheaper than
// cudaSetDevice on every launch.
cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess || cur == device) return err;
  return cudaSetDevice(device);
}

// Stage 1.  Filter mode: writes the result to (out_v, out_i) [n_q, k] when
// splits == 1, else each split's best k to [n_q, splits, k].  Score mode
// (kScores): writes every score to out_v [n_q, n_docs]; k and k_pad are
// not read.
template <typename T, bool kScores>
int launch_select(const void* q, const void* c, void* out_v, void* out_i,
                  int n_q, int n_docs, int d, int k, int k_pad, int splits,
                  int per_split, int stages, int device, void* stream) {
  const int cap = kScores ? 0 : k_pad + kCand;
  if (n_q < 1 || n_docs < 1 || n_docs >= kIdxPad || d < 1 || splits < 1 ||
      splits > 65535 || per_split < 1 ||
      static_cast<long long>(splits) * per_split < n_docs ||
      stages < 2 || stages > kMaxStages ||
      tma_smem(stages, cap) > kMaxSmem || regs_smem(cap) > kMaxSmem) {
    return cudaErrorInvalidValue;
  }
  if (!kScores && (k < 1 || k > n_docs || k > k_pad || k_pad > 1024 ||
                   (k_pad & (k_pad - 1)) != 0)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n_q + kBQ - 1) / kBQ, splits);
  // TMA takes fp32 rows of 16-byte multiples from 16-byte aligned bases
  const bool tma = std::is_same<T, float>::value && d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0;
  if (tma) {
    CUtensorMap tm_q, tm_c;
    if (!make_map(&tm_q, q, n_q, d, kBQ) ||
        !make_map(&tm_c, c, n_docs, d, kBN)) {
      return cudaErrorNotSupported;
    }
    static bool done[64] = {};
    err = allow_max_smem(dense_topk_tma_kernel<kScores>, device, done);
    if (err != cudaSuccess) return err;
    dense_topk_tma_kernel<kScores>
        <<<grid, kThreads + 32, tma_smem(stages, cap), st>>>(
            tm_q, tm_c, static_cast<float*>(out_v), static_cast<int*>(out_i),
            n_q, n_docs, d, k, k_pad, per_split, stages);
  } else {
    static bool done[64] = {};
    err = allow_max_smem(dense_topk_select_kernel<T, kScores>, device, done);
    if (err != cudaSuccess) return err;
    dense_topk_select_kernel<T, kScores><<<grid, kThreads, regs_smem(cap),
                                           st>>>(
        static_cast<const T*>(q), static_cast<const T*>(c),
        static_cast<float*>(out_v), static_cast<int*>(out_i), n_q, n_docs, d,
        k, k_pad, per_split);
  }
  return cudaGetLastError();
}

// The large-k path for one query chunk of n_q rows (see above): `work`
// holds, in this order, the scores [n_q, n_docs] f32, the counts
// [n_q, 4, 256], the slices' counts [n_q, slices, 2], and the winners'
// keys and indices [n_q, k_pad] each.  The launches: stage 1 in score
// mode, 4 histogram passes, the count, the compaction, then the sort.
template <typename T>
int launch_large(const void* q, const void* c, void* work, void* vals,
                 void* idxs, int n_q, int n_docs, int d, int k, int k_pad,
                 int splits, int per_split, int stages, int slices,
                 int device, void* stream) {
  if (n_q < 1 || n_q > 65535 || n_docs < 1 || k < 1 || k > n_docs ||
      k > k_pad || (k_pad & (k_pad - 1)) != 0 || k_pad >= kIdxPad ||
      slices != (n_docs + kSlice - 1) / kSlice) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = static_cast<cudaError_t>(launch_select<T, true>(
      q, c, work, nullptr, n_q, n_docs, d, 0, 0, splits, per_split, stages,
      device, stream));
  if (err != cudaSuccess) return err;
  const auto st = static_cast<cudaStream_t>(stream);
  float* scores = static_cast<float*>(work);
  unsigned* hist = reinterpret_cast<unsigned*>(
      scores + static_cast<size_t>(n_q) * n_docs);
  int* counts = reinterpret_cast<int*>(hist + static_cast<size_t>(n_q) * 1024);
  unsigned* win_key = reinterpret_cast<unsigned*>(
      counts + static_cast<size_t>(n_q) * slices * 2);
  int* win_idx = reinterpret_cast<int*>(
      win_key + static_cast<size_t>(n_q) * k_pad);
  err = cudaMemsetAsync(hist, 0, static_cast<size_t>(n_q) * 1024 * 4, st);
  if (err != cudaSuccess) return err;
  const dim3 grid(slices, n_q);
  for (int pass = 0; pass < 4; ++pass) {
    topk_hist_kernel<<<grid, kSelThreads, 0, st>>>(scores, hist, n_docs, k,
                                                   pass);
  }
  topk_count_kernel<<<grid, kSelThreads, 0, st>>>(scores, hist, counts,
                                                  n_docs, k);
  topk_compact_kernel<<<grid, kSelThreads, 0, st>>>(
      scores, hist, counts, win_key, win_idx, n_docs, k, k_pad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  static bool done[64] = {};
  err = allow_max_smem(topk_sort_local_kernel, device, done);
  if (err != cudaSuccess) return err;
  const int chunk = k_pad < kSortChunk ? k_pad : kSortChunk;
  const dim3 local(k_pad / chunk, n_q);
  const int local_smem = chunk * 8;
  float* fv = static_cast<float*>(vals);
  int* fi = static_cast<int*>(idxs);
  topk_sort_local_kernel<<<local, kSortThreads, local_smem, st>>>(
      win_key, win_idx, fv, fi, k, k_pad, 0, k_pad == chunk);
  for (int size = 2 * chunk; size <= k_pad; size <<= 1) {
    for (int stride = size / 2; stride >= chunk; stride /= 2) {
      topk_sort_step_kernel<<<dim3((k_pad / 2 + 255) / 256, n_q), 256, 0,
                              st>>>(win_key, win_idx, k_pad, size, stride);
    }
    topk_sort_local_kernel<<<local, kSortThreads, local_smem, st>>>(
        win_key, win_idx, fv, fi, k, k_pad, size, size == k_pad);
  }
  return cudaGetLastError();
}

}  // namespace

// Stage 1.  q [n_q, d] and c [n_docs, d] row-major on `device`; split s
// covers docs [s * per_split, (s + 1) * per_split).  With splits == 1,
// out_v [n_q, k] fp32 and out_i [n_q, k] int32 get the result; with
// more, [n_q, splits, k] get each split's best k, for dense_topk_merge.
// `stages` is the depth of the fp32 TMA ring (2 to kMaxStages; the
// register path always takes 2).  Launches on `stream` and returns its
// CUDA error code (0 on success); does not synchronise.
extern "C" int dense_topk_select_f32(const void* q, const void* c,
                                     void* out_v, void* out_i, int n_q,
                                     int n_docs, int d, int k, int k_pad,
                                     int splits, int per_split, int stages,
                                     int device, void* stream) {
  return launch_select<float, false>(q, c, out_v, out_i, n_q, n_docs, d, k,
                                     k_pad, splits, per_split, stages, device,
                                     stream);
}

extern "C" int dense_topk_select_bf16(const void* q, const void* c,
                                      void* out_v, void* out_i, int n_q,
                                      int n_docs, int d, int k, int k_pad,
                                      int splits, int per_split, int stages,
                                      int device, void* stream) {
  return launch_select<__nv_bfloat16, false>(q, c, out_v, out_i, n_q, n_docs,
                                             d, k, k_pad, splits, per_split,
                                             stages, device, stream);
}

// Stage 2: part_v / part_i [n_q, splits, k] from dense_topk_select_* ->
// vals [n_q, k] fp32, idxs [n_q, k] int32, on `stream`; returns the CUDA
// error code of the launch.
extern "C" int dense_topk_merge(const void* part_v, const void* part_i,
                                void* vals, void* idxs, int n_q, int splits,
                                int k, int k_pad, int device, void* stream) {
  if (n_q < 1 || splits < 2 || k < 1 || k > k_pad || k_pad > 1024 ||
      (k_pad & (k_pad - 1)) != 0 || merge_smem(splits, k, k_pad) > kMaxSmem) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return err;
  static bool done[64] = {};
  err = allow_max_smem(dense_topk_merge_kernel, device, done);
  if (err != cudaSuccess) return err;
  dense_topk_merge_kernel<<<n_q, kMergeThreads,
                            static_cast<int>(merge_smem(splits, k, k_pad)),
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_v), static_cast<const int*>(part_i),
      static_cast<float*>(vals), static_cast<int*>(idxs), splits, k, k_pad);
  return cudaGetLastError();
}

// The large-k path for a query chunk: q [n_q, d] (the chunk's rows),
// c [n_docs, d], `work` as launch_large lays it out, vals [n_q, k] fp32
// and idxs [n_q, k] int32 (the chunk's rows of the result).  Launches on
// `stream` and returns the CUDA error code (0 on success).
extern "C" int dense_topk_large_f32(const void* q, const void* c, void* work,
                                    void* vals, void* idxs, int n_q,
                                    int n_docs, int d, int k, int k_pad,
                                    int splits, int per_split, int stages,
                                    int slices, int device, void* stream) {
  return launch_large<float>(q, c, work, vals, idxs, n_q, n_docs, d, k,
                             k_pad, splits, per_split, stages, slices, device,
                             stream);
}

extern "C" int dense_topk_large_bf16(const void* q, const void* c,
                                     void* work, void* vals, void* idxs,
                                     int n_q, int n_docs, int d, int k,
                                     int k_pad, int splits, int per_split,
                                     int stages, int slices, int device,
                                     void* stream) {
  return launch_large<__nv_bfloat16>(q, c, work, vals, idxs, n_q, n_docs, d,
                                     k, k_pad, splits, per_split, stages,
                                     slices, device, stream);
}
