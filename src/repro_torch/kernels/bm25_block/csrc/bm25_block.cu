// Blocked BM25 scoring over a dense term-frequency tile, for Hopper (sm_90a).
//
// Replaces the TPU kernel `bm25_block` of the reference package
// (src/repro/kernels/bm25_block/kernel.py:51, pallas_call at :60).  It
// computes the same function in fp32:
//
//   dl_norm[d] = k1 * (1 - b + b * doc_len[d] / avg_dl)
//   score[d]   = sum_t idf[t] * tf[t, d] * (k1 + 1) / (tf[t, d] + dl_norm[d])
//
// where a term with tf[t, d] == 0 adds exactly 0 (kernel.py:45): the
// saturation is computed only where tf > 0, so k1 = 0, or b = 1 with a
// zero doc length, gives 0 and not NaN.  The division is IEEE (no fast
// math).
//
// What bounds it on an H100: bytes.  The tile is read once (4*T*D bytes)
// against about 5 flops per nonzero entry, so at the reference bench's
// tile (T = 64, D = 8,192) the bound is 2.2 MB over 3.35 TB/s, 0.64 us;
// a Table 2 query's tile (a few terms over 39,600 docs) is well under a
// microsecond, so one launch's fixed cost is most of a call.  The design:
//
// * a block of 8 warps takes a tile of 128 docs and splits the T terms
//   over its warps (warp w takes terms w, w + 8, ...), so a small D still
//   gives D / 128 blocks and the terms of a long query run side by side;
// * each lane holds 4 neighbouring docs: where D is a multiple of 4 and
//   the tile 16-byte aligned it reads them with one 16-byte load per term
//   (a warp reads 512 contiguous bytes), otherwise with 4-byte loads, a
//   warp reading 128 contiguous bytes per instruction; idf[t] is one
//   broadcast load per term;
// * a warp issues the loads of 4 of its terms before it adds the first,
//   so a lane keeps 4 loads in flight rather than 1;
// * the warps' partial sums are added in shared memory in warp order
//   0..7, with no atomics, so two runs give the same bits.  The sum is
//   no longer in t order: each warp sums its terms in order, then the
//   warps' sums are added.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kDocs = 128;         // docs a block: 4 a lane
constexpr int kUnroll = 4;         // terms a warp loads before adding

// Adds term t's weights for this lane's docs to acc.
__device__ __forceinline__ void add_term(float (&acc)[4], const float (&f)[4],
                                         const float (&dl_norm)[4], float w,
                                         float k1p1) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (f[j] > 0.0f) {
      acc[j] = fmaf(w, f[j] * k1p1 / (f[j] + dl_norm[j]), acc[j]);
    }
  }
}

// kVec: lane l holds docs 4l..4l+3 of the block's tile, read as one
// 16-byte load per term; otherwise docs l, l + 32, l + 64, l + 96.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
bm25_block_kernel(const float* __restrict__ tf, const float* __restrict__ idf,
                  const float* __restrict__ doc_len, float* __restrict__ out,
                  int n_terms, int n_docs, float k1, float b, float avg_dl) {
  __shared__ float part[kWarps][kDocs];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d0 = blockIdx.x * kDocs;
  int doc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    doc[j] = d0 + (kVec ? 4 * lane + j : lane + 32 * j);
  }
  float dl_norm[4], acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    dl_norm[j] = doc[j] < n_docs
                     ? k1 * (1.0f - b + b * __ldg(doc_len + doc[j]) / avg_dl)
                     : 1.0f;
  }
  const float k1p1 = k1 + 1.0f;
  // kUnroll of the warp's terms at a time: their loads are all issued
  // before the first is used, then they are added in term order
  for (int t0 = warp; t0 < n_terms; t0 += kUnroll * kWarps) {
    float f[kUnroll][4], w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * kWarps;
      const float* row = tf + static_cast<size_t>(t) * n_docs;
      w[u] = t < n_terms ? __ldg(idf + t) : 0.0f;
      if constexpr (kVec) {
        // n_docs % 4 == 0: a lane's 4 docs are all in range or all out
        const float4 v =
            t < n_terms && doc[0] < n_docs
                ? __ldg(reinterpret_cast<const float4*>(row + doc[0]))
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        f[u][0] = v.x;
        f[u][1] = v.y;
        f[u][2] = v.z;
        f[u][3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          f[u][j] = t < n_terms && doc[j] < n_docs ? __ldg(row + doc[j])
                                                   : 0.0f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add_term(acc, f[u], dl_norm, w[u], k1p1);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) part[warp][doc[j] - d0] = acc[j];
  __syncthreads();
  if (threadIdx.x < kDocs && d0 + static_cast<int>(threadIdx.x) < n_docs) {
    float sum = part[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += part[w][threadIdx.x];
    out[d0 + threadIdx.x] = sum;
  }
}

}  // namespace

// tf [n_terms, n_docs], idf [n_terms] and doc_len [n_docs], fp32 and
// row-major on `device`; out [n_docs] fp32 is written on `stream`.
// n_terms may be 0 (every score 0).  Returns the CUDA error code of the
// launch (0 on success); does not synchronise.  The device is made
// current only where it is not already.
extern "C" int bm25_block_f32(const void* tf, const void* idf,
                              const void* doc_len, void* out, int n_terms,
                              int n_docs, float k1, float b, float avg_dl,
                              int device, void* stream) {
  if (n_terms < 0 || n_docs < 1) return cudaErrorInvalidValue;
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int blocks = (n_docs + kDocs - 1) / kDocs;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const float*>(tf);
  const auto* i = static_cast<const float*>(idf);
  const auto* l = static_cast<const float*>(doc_len);
  auto* o = static_cast<float*>(out);
  if (n_docs % 4 == 0 && reinterpret_cast<uintptr_t>(tf) % 16 == 0) {
    bm25_block_kernel<true><<<blocks, kThreads, 0, st>>>(
        t, i, l, o, n_terms, n_docs, k1, b, avg_dl);
  } else {
    bm25_block_kernel<false><<<blocks, kThreads, 0, st>>>(
        t, i, l, o, n_terms, n_docs, k1, b, avg_dl);
  }
  return cudaGetLastError();
}
