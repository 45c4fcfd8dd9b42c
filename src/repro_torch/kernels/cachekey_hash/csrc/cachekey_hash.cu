// Cache-key / provenance hashing, for Hopper (sm_90a).
//
// Replaces the TPU kernel `cachekey_hash` of the reference package
// (src/repro/kernels/cachekey_hash/kernel.py:54, pallas_call at :59).  It
// computes the same function: for each row of int32 tokens, two 32-bit
// FNV-1a lanes over the row's bytes, each token mixed as its 4 bytes in
// little-endian order (lowest byte first).  Lane 0 starts from the FNV
// offset 0x811C9DC5, lane 1 from 0x31415927; both use the prime
// 0x01000193.  Tokens are int32 reinterpreted as uint32, and every
// multiply wraps modulo 2^32, as the uint32 arithmetic of the reference.
//
// What bounds it on an H100: at [N, L] the larger of the bytes, (4*N*L +
// 8*N) over 3.35 TB/s, the operations, 16*N*L 32-bit xors and multiplies
// over 64 per SM and clock (132 SMs, 1.98 GHz: 16.7 T/s), and one row's
// chain: FNV-1a cannot be split along a row, so a row is 4*L dependent
// steps, each an xor and then a multiply.  At N = 65,536, L = 64 the
// bytes bound it (5.2 us); at N = 1 (a provenance digest) the chain does.
//
// The design: a block takes 256 rows, one a thread, and stages them
// through shared memory in chunks of kChunk words.
// * The loads are coalesced: where L is a multiple of 4 and the base is
//   16-byte aligned, each thread issues 16-byte loads and a warp reads
//   four rows' 128-byte segments; otherwise 4-byte loads, a warp reading
//   32 consecutive words of one row.  The next chunk's 16-byte loads are
//   issued before this chunk is folded, so they are in flight meanwhile.
// * In shared memory a row's stride is kChunk + 1 words, so the 32 lanes
//   of a warp, each reading word i of its own row, hit 32 banks, and the
//   16-byte stores of a warp (4 rows x 8 vectors) are conflict-free too.
// * Each thread then folds its row from shared memory; the two lanes are
//   independent chains, which keeps two multiplies in flight.
//
// Output: out[N, 2] of 32-bit words holding the two lanes' bits (the
// wrapper allocates it as int32; the bits are the reference's uint32).
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;               // rows a block
constexpr int kChunk = 32;                  // words a row stages at a time
constexpr int kLd = kChunk + 1;             // a row's stride in shared memory
// 16-byte vectors in a row's chunk; a block's 256 rows of them are also
// kVecs a thread
constexpr int kVecs = kChunk / 4;
constexpr uint32_t kFnvOffset = 0x811C9DC5u;
constexpr uint32_t kLane2Offset = 0x31415927u;
constexpr uint32_t kFnvPrime = 0x01000193u;

// The 16-byte loads of chunk `ch`: vector e = i * kThreads + tid is
// vector e % kVecs of row e / kVecs; zeros past the rows or the columns.
__device__ __forceinline__ void load_vecs(const uint32_t* __restrict__ tokens,
                                          int row0, int rows, int n_cols,
                                          int ch, uint4 (&r)[kVecs]) {
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int e = i * kThreads + threadIdx.x;
    const int row = e / kVecs, col = ch * kChunk + (e % kVecs) * 4;
    r[i] = (row < rows && col < n_cols)
               ? __ldg(reinterpret_cast<const uint4*>(
                     tokens + static_cast<size_t>(row0 + row) * n_cols + col))
               : make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void store_vecs(uint32_t* buf,
                                           const uint4 (&r)[kVecs]) {
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int e = i * kThreads + threadIdx.x;
    uint32_t* p = buf + (e / kVecs) * kLd + (e % kVecs) * 4;
    p[0] = r[i].x;
    p[1] = r[i].y;
    p[2] = r[i].z;
    p[3] = r[i].w;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
cachekey_hash_kernel(const uint32_t* __restrict__ tokens,
                     uint32_t* __restrict__ out, int n_rows, int n_cols) {
  __shared__ uint32_t buf[kThreads * kLd];
  const int row0 = blockIdx.x * kThreads;
  const int rows = min(kThreads, n_rows - row0);
  const int n_chunks = (n_cols + kChunk - 1) / kChunk;
  uint32_t h0 = kFnvOffset;
  uint32_t h1 = kLane2Offset;
  uint4 r[kVecs];
  if (kVec && n_chunks > 0) load_vecs(tokens, row0, rows, n_cols, 0, r);
  for (int ch = 0; ch < n_chunks; ++ch) {
    __syncthreads();                         // the last chunk is folded
    if constexpr (kVec) {
      store_vecs(buf, r);
    } else {
      // word e = i * kThreads + tid: word e % kChunk of row e / kChunk
      for (int e = threadIdx.x; e < kThreads * kChunk; e += kThreads) {
        const int row = e / kChunk, col = ch * kChunk + e % kChunk;
        buf[row * kLd + e % kChunk] =
            (row < rows && col < n_cols)
                ? __ldg(tokens + static_cast<size_t>(row0 + row) * n_cols +
                        col)
                : 0u;
      }
    }
    __syncthreads();
    if (kVec && ch + 1 < n_chunks) {
      load_vecs(tokens, row0, rows, n_cols, ch + 1, r);
    }
    if (threadIdx.x < rows) {
      const uint32_t* w = buf + threadIdx.x * kLd;
      const int n = min(kChunk, n_cols - ch * kChunk);
      for (int i = 0; i < n; ++i) {
        const uint32_t word = w[i];
#pragma unroll
        for (int shift = 0; shift < 32; shift += 8) {
          const uint32_t byte = (word >> shift) & 0xFFu;
          h0 = (h0 ^ byte) * kFnvPrime;
          h1 = (h1 ^ byte) * kFnvPrime;
        }
      }
    }
  }
  if (threadIdx.x < rows) {
    out[2 * static_cast<size_t>(row0 + threadIdx.x)] = h0;
    out[2 * static_cast<size_t>(row0 + threadIdx.x) + 1] = h1;
  }
}

}  // namespace

// tokens [n_rows, n_cols] int32 row-major on `device`; out [n_rows, 2] of
// 32-bit words is written on `stream`.  Returns the CUDA error code of the
// launch (0 on success); does not synchronise.  The device is made
// current only where it is not already.
extern "C" int cachekey_hash_u32(const void* tokens, void* out, int n_rows,
                                 int n_cols, int device, void* stream) {
  if (n_rows < 1 || n_cols < 0) return cudaErrorInvalidValue;
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int blocks = (n_rows + kThreads - 1) / kThreads;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const uint32_t*>(tokens);
  auto* o = static_cast<uint32_t*>(out);
  if (n_cols % 4 == 0 && reinterpret_cast<uintptr_t>(tokens) % 16 == 0) {
    cachekey_hash_kernel<true><<<blocks, kThreads, 0, st>>>(t, o, n_rows,
                                                            n_cols);
  } else {
    cachekey_hash_kernel<false><<<blocks, kThreads, 0, st>>>(t, o, n_rows,
                                                             n_cols);
  }
  return cudaGetLastError();
}
