// EmbeddingBag (a weighted sum of table rows per bag), for Hopper (sm_90a).
//
// Replaces the TPU kernel `embedding_bag` of the reference package
// (src/repro/kernels/embedding_bag/kernel.py:43, pallas_call at :63).  It
// computes the same function, the sum combiner:
//
//   out[b, :] = sum_l w[b, l] * table[clip(ids[b, l], 0, V - 1), :]
//
// accumulated in fp32 in l order with fmaf and cast to the table's dtype
// once at the end: the reference's grid has l innermost (kernel.py:32-40,
// :66-69).  The weights arrive in the table's dtype (the wrapper casts them
// first, as kernel.py:51 does) and are widened to fp32; no weights means 1.
// Ids are clipped to [0, V - 1] as the reference's oracle clips (ref.py:16,
// mode="clip"); the Pallas index map reads them unclipped (kernel.py:59), a
// divergence of the reference.  With `mean`, the epilogue also does the
// reference op's division (ops.py of the reference):
//
//   out[b, :] = T(sum) / max(T(sum_l w[b, l]), T(1e-9))
//
// with the weight sum in fp32 in l order (L without weights) and the
// division in fp32, rounded to the table's dtype T.
//
// What bounds it on an H100: bytes, and the latency of the gather.  At
// MIND's serving shape (table [1,000,000, 64] fp32, B = 512 bags of L = 50)
// it reads ~25,300 distinct rows of 256 B, 6.5 MB, and writes 131 KB: 2.03 us
// at 3.35 TB/s, against 3.3 MFLOP.  Each column must sum its bag in l order,
// so a bag's 50 rows feed one chain of FMAs; one warp per bag gives only
// 512 warps, at most 4 on an SM, and each warp has to keep rows in flight:
//
// * a warp per (bag, column group): `lanes` lanes each copy VEC bytes (16,
//   8, 4, or one bf16 element where the table is only 2-byte aligned) of a
//   row, so a row is one coalesced warp copy; rows wider than 32 * VEC
//   bytes take more groups, i.e. more warps;
// * the bag's ids (clipped) and weights are loaded once, coalesced: lane i
//   holds slot i of each chunk of 32, and chunk c + 2 is loaded on entering
//   chunk c, so a row's id comes from a load issued 32 steps earlier and
//   reaches every lane by __shfl_sync;
// * U rows in flight: a ring of U row slots a warp in shared memory, filled
//   by cp.async in two batches of K = U / 2 rows, one commit group a batch.
//   A batch waits until the other batch is all that is pending (its own
//   rows have landed), reads its K slots, does their FMAs in l order, then
//   issues the K rows U steps ahead into its slots.  cp.async's groups
//   complete in order.  16-byte copies are .cg (L2 only: a row is read once
//   per bag); 8- and 4-byte ones can only be .ca, so plan() prefers 16;
// * kernel.plan() picks VEC, U and the warps a block.  At MIND serve: VEC 16
//   (16 lanes x 16 B = one 256-B row), U = 8, one warp a block, 512 blocks:
//   512 warps x 8 rows x 256 B = 1 MiB in flight.
//
// What the H100 showed (tools/torch_embedding_bag_bench.py --sweep and
// --probe, device-only, L2 flushed): a ring in registers lost its overlap,
// because ptxas put all of the ring's loads on one scoreboard and waited for
// every one at the end of each unrolled pass; U = 16 or 32 (2 or 4 MiB in
// flight, Little's law's ~2 MB) ran slower than U = 8.  A bag's time grows
// by ~0.1 us a row at any U >= 8, from L2 as from DRAM, so MIND serve sits
// at ~8 us, a quarter of its bytes bound: each warp's chain of rows, not
// the card's bandwidth, bounds it (132 bags take nearly as long as 512).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T and back
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// VEC bytes of a row in 32-bit words (the low half of one word for VEC 2)
template <int VEC> struct Row {
  static constexpr int kWords = VEC >= 4 ? VEC / 4 : 1;
  uint32_t w[kWords];
};

// row bytes at `src` into the ring slot at shared address `dst`: cp.async
// (.cg for 16 bytes), or for one bf16 element a load and a store
template <int VEC>
__device__ __forceinline__ void copy_row(uint32_t dst, const void* src) {
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(dst), "l"(src) : "memory");
  } else if constexpr (VEC >= 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;"
                 :: "r"(dst), "l"(src), "n"(VEC) : "memory");
  } else {
    unsigned short h;
    asm volatile("ld.global.nc.L1::no_allocate.u16 %0, [%1];"
                 : "=h"(h) : "l"(src));
    asm volatile("st.shared.u16 [%0], %1;" :: "r"(dst), "h"(h) : "memory");
  }
}

__device__ __forceinline__ void commit_rows() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// until at most N commit groups are pending
template <int N> __device__ __forceinline__ void wait_rows() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

template <int VEC>
__device__ __forceinline__ void read_row(Row<VEC>& r, uint32_t src) {
  if constexpr (VEC == 16) {
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r.w[0]), "=r"(r.w[1]), "=r"(r.w[2]), "=r"(r.w[3])
                 : "r"(src) : "memory");
  } else if constexpr (VEC == 8) {
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
                 : "=r"(r.w[0]), "=r"(r.w[1]) : "r"(src) : "memory");
  } else if constexpr (VEC == 4) {
    asm volatile("ld.shared.u32 %0, [%1];"
                 : "=r"(r.w[0]) : "r"(src) : "memory");
  } else {
    unsigned short h;
    asm volatile("ld.shared.u16 %0, [%1];" : "=h"(h) : "r"(src) : "memory");
    r.w[0] = h;
  }
}

// element e of a row, widened to fp32
template <typename T, int VEC>
__device__ __forceinline__ float element(const Row<VEC>& r, int e) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(r.w[e]);
  } else {
    const uint32_t w = r.w[e >> 1];
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
}

// the E = VEC / sizeof(T) values of a lane, rounded to T and stored
template <typename T, int VEC>
__device__ __forceinline__ void store_row(T* p,
                                          const float (&v)[VEC / sizeof(T)]) {
  if constexpr (VEC == 2) {
    *reinterpret_cast<unsigned short*>(p) =
        __bfloat16_as_ushort(__float2bfloat16(v[0]));
  } else {
    Row<VEC> r;
#pragma unroll
    for (int k = 0; k < Row<VEC>::kWords; ++k) {
      if constexpr (sizeof(T) == 4) {
        r.w[k] = __float_as_uint(v[k]);
      } else {
        r.w[k] = static_cast<uint32_t>(
                     __bfloat16_as_ushort(__float2bfloat16(v[2 * k]))) |
                 (static_cast<uint32_t>(
                      __bfloat16_as_ushort(__float2bfloat16(v[2 * k + 1])))
                  << 16);
      }
    }
    if constexpr (VEC == 16) {
      *reinterpret_cast<uint4*>(p) = make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]);
    } else if constexpr (VEC == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(r.w[0], r.w[1]);
    } else {
      *reinterpret_cast<uint32_t*>(p) = r.w[0];
    }
  }
}

// slot `s` of a bag's ids (clipped) and weights, 0 and 0 past its end
template <typename T>
__device__ __forceinline__ void load_slot(const int* bag_ids, const T* bag_w,
                                          int s, int bag_len, int n_rows,
                                          int& id, float& w) {
  id = 0;
  w = 0.0f;
  if (s < bag_len) {
    id = min(max(__ldg(bag_ids + s), 0), n_rows - 1);
    w = bag_w == nullptr ? 1.0f : to_float(__ldg(bag_w + s));
  }
}

// a warp's ring is U slots of lanes * VEC bytes in dynamic shared memory
template <typename T, int VEC, int U>
__global__ void __launch_bounds__(256)
embedding_bag_kernel(const T* __restrict__ table, const int* __restrict__ ids,
                     const T* __restrict__ weights, T* __restrict__ out,
                     int n_rows, int d, int n_bags, int bag_len, int groups,
                     int lanes, int mean) {
  static_assert(U == 1 || U == 2 || U == 4 || U == 8, "U is 1, 2, 4 or 8");
  constexpr int E = VEC / sizeof(T);
  constexpr int K = U >= 2 ? U / 2 : 1;  // rows a batch
  constexpr int NB = U / K;              // batches in the ring
  extern __shared__ __align__(16) unsigned char ring[];
  const int lane = threadIdx.x & 31;
  const long long warp =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
      (threadIdx.x >> 5);
  if (warp >= static_cast<long long>(n_bags) * groups) return;  // whole warp
  const int bag = static_cast<int>(warp / groups);
  const int group = static_cast<int>(warp - static_cast<long long>(bag) * groups);
  const int* bag_ids = ids + static_cast<size_t>(bag) * bag_len;
  const T* bag_w =
      weights == nullptr ? nullptr : weights + static_cast<size_t>(bag) * bag_len;
  // lane j < lanes copies and sums piece j of the group's columns
  const int col = (group * lanes + lane) * E;
  const bool active = lane < lanes && col < d;  // d is a multiple of E (plan)
  const T* base = table + col;
  const uint32_t slot_stride = lanes * VEC;
  const uint32_t slot0 = static_cast<uint32_t>(__cvta_generic_to_shared(ring)) +
                         (threadIdx.x >> 5) * U * slot_stride + lane * VEC;

  // chunks c (a), c + 1 (b) and c + 2 (p, in flight) of ids and weights
  int id_a, id_b, id_p;
  float w_a, w_b, w_p;
  load_slot(bag_ids, bag_w, lane, bag_len, n_rows, id_a, w_a);
  load_slot(bag_ids, bag_w, 32 + lane, bag_len, n_rows, id_b, w_b);
  load_slot(bag_ids, bag_w, 64 + lane, bag_len, n_rows, id_p, w_p);

  // ring slots [j0, j0 + K) <- rows l0, l0 + 1, ... of the bag, whose ids
  // sit at slots s0, s0 + 1, ... of chunk c (and past 31, of chunk c + 1)
  auto copy_batch = [&](int j0, int l0, int s0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int s = s0 + j;
      const int id = __shfl_sync(kFull, s < 32 ? id_a : id_b, s & 31);
      if (active && l0 + j < bag_len) {
        copy_row<VEC>(slot0 + (j0 + j) * slot_stride,
                      base + static_cast<size_t>(id) * d);
      }
    }
    commit_rows();
  };

  // the ring in NB batches of K rows, one commit group a batch
#pragma unroll
  for (int b = 0; b < NB; ++b) copy_batch(b * K, b * K, b * K);
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.0f;
  float w_sum = 0.0f;
  for (int l0 = 0; l0 < bag_len; l0 += U) {
    const int s0 = l0 & 31;
    if (s0 == 0 && l0 != 0) {
      id_a = id_b;
      w_a = w_b;
      id_b = id_p;
      w_b = w_p;
      load_slot(bag_ids, bag_w, l0 + 64 + lane, bag_len, n_rows, id_p, w_p);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      wait_rows<NB - 1>();  // batch b has landed
      Row<VEC> r[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (active && l0 + b * K + k < bag_len) {
          read_row(r[k], slot0 + (b * K + k) * slot_stride);
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float w = __shfl_sync(kFull, w_a, s0 + b * K + k);
        if (l0 + b * K + k < bag_len) {
          w_sum += w;
          if (active) {
#pragma unroll
            for (int e = 0; e < E; ++e) {
              acc[e] = fmaf(element<T, VEC>(r[k], e), w, acc[e]);
            }
          }
        }
      }
      // the batch U rows ahead into the freed slots
      copy_batch(b * K, l0 + b * K + U, s0 + b * K + U);
    }
  }
  if (!active) return;
  if (mean) {
    const float lo = round_to<T>(1e-9f);
    float den = round_to<T>(w_sum);
    den = den < lo ? lo : den;  // NaN stays NaN, as torch.clamp
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = round_to<T>(acc[e]) / den;
  }
  store_row<T, VEC>(out + static_cast<size_t>(bag) * d + col, acc);
}

struct Args {
  const void* table;
  const int* ids;
  const void* weights;
  void* out;
  int n_rows, d, n_bags, bag_len, groups, lanes, mean;
};

constexpr int kMaxRing = 48 * 1024;  // ring bytes a block, without opt-in

template <typename T, int VEC, int U>
cudaError_t launch_one(const Args& a, int blocks, int warps,
                       cudaStream_t stream) {
  const int smem = warps * U * a.lanes * VEC;
  if (smem > kMaxRing) return cudaErrorInvalidValue;
  embedding_bag_kernel<T, VEC, U><<<blocks, 32 * warps, smem, stream>>>(
      static_cast<const T*>(a.table), a.ids, static_cast<const T*>(a.weights),
      static_cast<T*>(a.out), a.n_rows, a.d, a.n_bags, a.bag_len, a.groups,
      a.lanes, a.mean);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_vec(const Args& a, int rows_in_flight, int blocks,
                       int warps, cudaStream_t stream) {
  switch (rows_in_flight) {
    case 1: return launch_one<T, VEC, 1>(a, blocks, warps, stream);
    case 2: return launch_one<T, VEC, 2>(a, blocks, warps, stream);
    case 4: return launch_one<T, VEC, 4>(a, blocks, warps, stream);
    case 8: return launch_one<T, VEC, 8>(a, blocks, warps, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const void* table, const void* ids, const void* weights, void* out,
           int n_rows, int d, int n_bags, int bag_len, int vec,
           int rows_in_flight, int groups, int warps, int mean, int device,
           void* stream) {
  const int elt = static_cast<int>(sizeof(T));
  const long long row_bytes = static_cast<long long>(d) * elt;
  const long long n_warps = static_cast<long long>(n_bags) * groups;
  const long long blocks = warps > 0 ? (n_warps + warps - 1) / warps : 0;
  // the plan's invariants: VEC divides the row and the table's (and the
  // output's) base, the groups cover the row once, a block holds at most 8
  // warps
  if (n_rows < 1 || d < 1 || n_bags < 1 || bag_len < 0 || vec < elt ||
      row_bytes % vec != 0 ||
      reinterpret_cast<uintptr_t>(table) % static_cast<uintptr_t>(vec) != 0 ||
      reinterpret_cast<uintptr_t>(out) % static_cast<uintptr_t>(vec) != 0 ||
      groups != (row_bytes + 32LL * vec - 1) / (32LL * vec) || warps < 1 ||
      warps > 8 || blocks > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  // lanes of a column group: the row's VEC-byte pieces, spread evenly
  const int lanes = static_cast<int>((row_bytes / vec + groups - 1) / groups);
  const Args a{table, static_cast<const int*>(ids), weights, out, n_rows,
               d, n_bags, bag_len, groups, lanes, mean};
  auto s = static_cast<cudaStream_t>(stream);
  const int nb = static_cast<int>(blocks);
  switch (vec) {
    case 16: return launch_vec<T, 16>(a, rows_in_flight, nb, warps, s);
    case 8: return launch_vec<T, 8>(a, rows_in_flight, nb, warps, s);
    case 4: return launch_vec<T, 4>(a, rows_in_flight, nb, warps, s);
    case 2:
      if constexpr (sizeof(T) == 2) {
        return launch_vec<T, 2>(a, rows_in_flight, nb, warps, s);
      }
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// table [n_rows, d], ids [n_bags, bag_len] int32 and weights [n_bags,
// bag_len] (in the table's dtype, or NULL for all ones) row-major on
// `device`; out [n_bags, d] in the table's dtype is written on `stream`:
// the sum of each bag, or with `mean` != 0 that sum over the bag's weight
// sum.  `vec`, `rows_in_flight`, `groups` and `warps` are kernel.plan()'s.
// Returns the CUDA error code of the launch (0 on success); does not
// synchronise.
extern "C" int embedding_bag_f32(const void* table, const void* ids,
                                 const void* weights, void* out, int n_rows,
                                 int d, int n_bags, int bag_len, int vec,
                                 int rows_in_flight, int groups, int warps,
                                 int mean, int device, void* stream) {
  return launch<float>(table, ids, weights, out, n_rows, d, n_bags, bag_len,
                       vec, rows_in_flight, groups, warps, mean, device,
                       stream);
}

extern "C" int embedding_bag_bf16(const void* table, const void* ids,
                                  const void* weights, void* out, int n_rows,
                                  int d, int n_bags, int bag_len, int vec,
                                  int rows_in_flight, int groups, int warps,
                                  int mean, int device, void* stream) {
  return launch<__nv_bfloat16>(table, ids, weights, out, n_rows, d, n_bags,
                               bag_len, vec, rows_in_flight, groups, warps,
                               mean, device, stream);
}
