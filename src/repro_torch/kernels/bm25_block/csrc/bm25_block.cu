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
// zero doc length, gives 0 and not NaN.  Terms are summed in t order.
//
// What bounds it on an H100: bytes.  The tile is read once (4*T*D bytes)
// against about 5 flops per nonzero entry, so at the reference bench's
// tile (T = 64, D = 8,192) the bound is 2.2 MB over 3.35 TB/s, 0.64 us.
// This first version is simple rather than fast:
//
// * one thread per doc, 256-thread blocks; the thread computes dl_norm
//   once and walks the T terms with an fp32 accumulator;
// * for each term, neighbouring threads read neighbouring docs of the
//   row-major tile, so every load of a warp is one coalesced 128-byte
//   line; idf[t] is one broadcast load per term.
// The TPU version padded T to 8 and D to 128 for its tiles; here each
// thread masks the ragged edge itself, so the tile is read unpadded.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bm25_block_kernel(const float* __restrict__ tf, const float* __restrict__ idf,
                  const float* __restrict__ doc_len, float* __restrict__ out,
                  int n_terms, int n_docs, float k1, float b, float avg_dl) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= n_docs) return;
  const float dl_norm = k1 * (1.0f - b + b * __ldg(doc_len + d) / avg_dl);
  const float k1p1 = k1 + 1.0f;
  float acc = 0.0f;
  for (int t = 0; t < n_terms; ++t) {
    const float f = __ldg(tf + static_cast<size_t>(t) * n_docs + d);
    if (f > 0.0f) acc = fmaf(__ldg(idf + t), f * k1p1 / (f + dl_norm), acc);
  }
  out[d] = acc;
}

}  // namespace

// tf [n_terms, n_docs], idf [n_terms] and doc_len [n_docs], fp32 and
// row-major on `device`; out [n_docs] fp32 is written on `stream`.
// n_terms may be 0 (every score 0).  Returns the CUDA error code of the
// launch (0 on success); does not synchronise.
extern "C" int bm25_block_f32(const void* tf, const void* idf,
                              const void* doc_len, void* out, int n_terms,
                              int n_docs, float k1, float b, float avg_dl,
                              int device, void* stream) {
  if (n_terms < 0 || n_docs < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int blocks = (n_docs + kThreads - 1) / kThreads;
  bm25_block_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tf), static_cast<const float*>(idf),
      static_cast<const float*>(doc_len), static_cast<float*>(out), n_terms,
      n_docs, k1, b, avg_dl);
  return cudaGetLastError();
}
