// EmbeddingBag (a weighted sum of table rows per bag), for Hopper (sm_90a).
//
// Replaces the TPU kernel `embedding_bag` of the reference package
// (src/repro/kernels/embedding_bag/kernel.py:43, pallas_call at :63).  It
// computes the same function, the sum combiner:
//
//   out[b, :] = sum_l w[b, l] * table[clip(ids[b, l], 0, V - 1), :]
//
// accumulated in fp32 in l order and cast to the table's dtype once at the
// end (kernel.py:66-69).  The weights arrive in the table's dtype (the
// wrapper casts them first, as kernel.py:51 does) and are widened to fp32;
// no weights means 1.  Ids are clipped to [0, V - 1] as the reference's
// oracle clips (ref.py:16, mode="clip"); the Pallas index map reads them
// unclipped (kernel.py:59), a divergence of the reference.
//
// What bounds it on an H100: bytes.  It gathers B*L rows of d elements and
// does 2 flops per gathered element, so at MIND's serving shape (table
// [1,000,000, 64] fp32, B = 512, L = 50) it moves ~6.9 MB, 2 us at
// 3.35 TB/s, against 3.3 MFLOP.  This first version is simple rather than
// fast:
//
// * one warp per bag, four bags per 128-thread block;
// * lanes across d: lane j accumulates columns j, j + 32, j + 64 and
//   j + 96 of a 128-column group in fp32 registers, so a row is read by
//   one warp with neighbouring lanes on neighbouring addresses;
// * every lane reads the bag's id and weight for step l itself (one
//   broadcast load), then its columns of the row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarps = 4;            // bags per block
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 4;             // columns per lane and group of 128

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const T* __restrict__ table, const int* __restrict__ ids,
                     const T* __restrict__ weights, T* __restrict__ out,
                     int n_rows, int d, int n_bags, int bag_len) {
  const int lane = threadIdx.x & 31;
  const int bag = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (bag >= n_bags) return;
  const int* bag_ids = ids + static_cast<size_t>(bag) * bag_len;
  const T* bag_w = weights == nullptr
                       ? nullptr
                       : weights + static_cast<size_t>(bag) * bag_len;
  T* out_row = out + static_cast<size_t>(bag) * d;
  for (int c0 = lane; c0 < d; c0 += 32 * kCols) {
    float acc[kCols] = {};
#pragma unroll 4
    for (int l = 0; l < bag_len; ++l) {
      const int id = min(max(__ldg(bag_ids + l), 0), n_rows - 1);
      const float w = bag_w == nullptr ? 1.0f : to_float(__ldg(bag_w + l));
      const T* row = table + static_cast<size_t>(id) * d;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int c = c0 + 32 * k;
        if (c < d) acc[k] = fmaf(to_float(__ldg(row + c)), w, acc[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int c = c0 + 32 * k;
      if (c < d) out_row[c] = from_float<T>(acc[k]);
    }
  }
}

template <typename T>
int launch(const void* table, const void* ids, const void* weights, void* out,
           int n_rows, int d, int n_bags, int bag_len, int device,
           void* stream) {
  if (n_rows < 1 || d < 1 || n_bags < 1 || bag_len < 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int blocks = (n_bags + kWarps - 1) / kWarps;
  embedding_bag_kernel<T><<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(table), static_cast<const int*>(ids),
      static_cast<const T*>(weights), static_cast<T*>(out), n_rows, d, n_bags,
      bag_len);
  return cudaGetLastError();
}

}  // namespace

// table [n_rows, d], ids [n_bags, bag_len] int32 and weights [n_bags,
// bag_len] (in the table's dtype, or NULL for all ones) row-major on
// `device`; out [n_bags, d] in the table's dtype is written on `stream`.
// Returns the CUDA error code of the launch (0 on success); does not
// synchronise.
extern "C" int embedding_bag_f32(const void* table, const void* ids,
                                 const void* weights, void* out, int n_rows,
                                 int d, int n_bags, int bag_len, int device,
                                 void* stream) {
  return launch<float>(table, ids, weights, out, n_rows, d, n_bags, bag_len,
                       device, stream);
}

extern "C" int embedding_bag_bf16(const void* table, const void* ids,
                                  const void* weights, void* out, int n_rows,
                                  int d, int n_bags, int bag_len, int device,
                                  void* stream) {
  return launch<__nv_bfloat16>(table, ids, weights, out, n_rows, d, n_bags,
                               bag_len, device, stream);
}
