// Dense-retrieval scoring with a fused streaming top-k, for Hopper (sm_90a).
//
// Replaces the TPU kernel `dense_topk` of the reference package
// (src/repro/kernels/dense_topk/kernel.py:96, pallas_call at :116).  It
// computes the same function: scores q . c^T in fp32, and per query row
// the k best (score, doc index) pairs under the total order "score
// descending, then doc index ascending".  Docs past N are masked to
// (NEG_INF = -1e30, IDX_PAD = 2^30) so they can never win.
//
// What bounds it on an H100: at the retrieval shape of the Table 2
// experiment (Q = 53 queries, N = 39,600 docs, d = 128, fp32) the corpus
// is ~20 MB, read once (6 us at 3.35 TB/s), and the products are
// 0.54 GFLOP of fp32 FMA (8 us at 67 TFLOP/s), so the bound is the FMA
// rate.  This first version is simple rather than fast:
//
// * one block of 256 threads per query row, so a 53-query batch keeps
//   53 of the 132 SMs busy and each block re-reads the corpus (from L2,
//   which holds all 20 MB);
// * each thread scores whole docs with one sequential fp32 FMA chain over
//   d (no TF32, no tensor cores), into a tile of TILE docs in shared
//   memory;
// * the tile is bitonic-sorted in shared memory, and its best K_PAD
//   entries are merged into the running top-K_PAD buffer (K_PAD is the
//   next power of two >= k): elementwise best of the running buffer and
//   the reversed tile head gives a bitonic sequence holding the top K_PAD
//   of both, which one bitonic merge puts in order.
//
// Shared memory: (K_PAD + TILE) * 8 bytes for the (score, index) pairs
// plus d * 4 bytes for the query row; 16.9 KB at k <= 1024, d = 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;         // docs per tile; power of two, >= K_PAD
constexpr float kNegInf = -1e30f;
constexpr int kIdxPad = 1 << 30;    // > any real doc index

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
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

// Sorts n (a power of two) entries best first.
__device__ void bitonic_sort(float* v, int* ix, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < n / 2; t += blockDim.x) {
        const int lo = lower_slot(t, stride);
        cmp_swap(v, ix, lo, lo + stride, (lo & size) == 0);
      }
      __syncthreads();
    }
  }
}

// Sorts a bitonic sequence of n (a power of two) entries best first.
__device__ void bitonic_merge(float* v, int* ix, int n) {
  for (int stride = n >> 1; stride > 0; stride >>= 1) {
    for (int t = threadIdx.x; t < n / 2; t += blockDim.x) {
      const int lo = lower_slot(t, stride);
      cmp_swap(v, ix, lo, lo + stride, true);
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dense_topk_kernel(const T* __restrict__ q, const T* __restrict__ c,
                  float* __restrict__ vals, int* __restrict__ idxs,
                  int n_docs, int d, int k, int k_pad) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* run_v = reinterpret_cast<float*>(smem);          // [k_pad]
  int* run_i = reinterpret_cast<int*>(run_v + k_pad);     // [k_pad]
  float* tile_v = reinterpret_cast<float*>(run_i + k_pad);  // [kTile]
  int* tile_i = reinterpret_cast<int*>(tile_v + kTile);     // [kTile]
  float* q_s = reinterpret_cast<float*>(tile_i + kTile);    // [d]

  const size_t row = blockIdx.x;
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    q_s[j] = load(q + row * d + j);
  }
  for (int j = threadIdx.x; j < k_pad; j += blockDim.x) {
    run_v[j] = kNegInf;
    run_i[j] = kIdxPad;
  }
  __syncthreads();

  for (int base = 0; base < n_docs; base += kTile) {
    for (int t = threadIdx.x; t < kTile; t += blockDim.x) {
      const int doc = base + t;
      float s = kNegInf;
      int id = kIdxPad;
      if (doc < n_docs) {
        const T* crow = c + static_cast<size_t>(doc) * d;
        float acc = 0.0f;
        for (int j = 0; j < d; ++j) acc = fmaf(q_s[j], load(crow + j), acc);
        s = acc;
        id = doc;
      }
      tile_v[t] = s;
      tile_i[t] = id;
    }
    __syncthreads();
    bitonic_sort(tile_v, tile_i, kTile);
    // run is best first and the tile head read backwards is worst first,
    // so their elementwise best is bitonic and holds the top k_pad of both
    for (int t = threadIdx.x; t < k_pad; t += blockDim.x) {
      const float vb = tile_v[k_pad - 1 - t];
      const int ib = tile_i[k_pad - 1 - t];
      if (better(vb, ib, run_v[t], run_i[t])) {
        run_v[t] = vb;
        run_i[t] = ib;
      }
    }
    __syncthreads();
    bitonic_merge(run_v, run_i, k_pad);
  }

  for (int t = threadIdx.x; t < k; t += blockDim.x) {
    vals[row * k + t] = run_v[t];
    idxs[row * k + t] = run_i[t];
  }
}

template <typename T>
int launch(const void* q, const void* c, void* vals, void* idxs, int n_q,
           int n_docs, int d, int k, int k_pad, int device, void* stream) {
  if (n_q < 1 || n_docs < 1 || n_docs >= kIdxPad || d < 1 || k < 1 ||
      k > k_pad || k_pad > kTile || (k_pad & (k_pad - 1)) != 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t smem = static_cast<size_t>(k_pad + kTile) * 8 +
                      static_cast<size_t>(d) * 4;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(dense_topk_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dense_topk_kernel<T><<<n_q, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(c),
      static_cast<float*>(vals), static_cast<int*>(idxs), n_docs, d, k, k_pad);
  return cudaGetLastError();
}

}  // namespace

// q [n_q, d] and c [n_docs, d] row-major on `device`; vals [n_q, k] fp32 and
// idxs [n_q, k] int32 are written on `stream`.  Returns the CUDA error code
// of the launch (0 on success); does not synchronise.
extern "C" int dense_topk_f32(const void* q, const void* c, void* vals,
                              void* idxs, int n_q, int n_docs, int d, int k,
                              int k_pad, int device, void* stream) {
  return launch<float>(q, c, vals, idxs, n_q, n_docs, d, k, k_pad, device,
                       stream);
}

extern "C" int dense_topk_bf16(const void* q, const void* c, void* vals,
                               void* idxs, int n_q, int n_docs, int d, int k,
                               int k_pad, int device, void* stream) {
  return launch<__nv_bfloat16>(q, c, vals, idxs, n_q, n_docs, d, k, k_pad,
                               device, stream);
}
