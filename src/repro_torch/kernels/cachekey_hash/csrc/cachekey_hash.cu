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
// What bounds it on an H100: the work is a sequential fold along each row,
// 8 byte-mixes per token (4 bytes, 2 lanes), each an xor and a multiply,
// and the input is read once (4 bytes a token).  At [N, L] the bound is the
// larger of (4*N*L + 8*N) bytes over 3.35 TB/s and 16*N*L 32-bit integer
// operations over 64 per SM and clock (132 SMs, 1.98 GHz: 16.7 T/s); at
// N = 65,536, L = 64 that is 5.2 us, bound by bytes.  A row's fold cannot
// be split, so at N = 1 (a provenance digest) one thread does all of it
// and its latency, not either bound, sets the time.  This first version is
// simple rather than fast:
//
// * one thread per row, a 256-thread block per 256 rows; each thread reads
//   its own row token by token, so neighbouring threads read addresses L*4
//   bytes apart (uncoalesced when L > 1);
// * the two lanes are independent dependency chains, which gives the
//   thread two multiplies in flight.
//
// Output: out[N, 2] of 32-bit words holding the two lanes' bits (the
// wrapper allocates it as int32; the bits are the reference's uint32).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kFnvOffset = 0x811C9DC5u;
constexpr uint32_t kLane2Offset = 0x31415927u;
constexpr uint32_t kFnvPrime = 0x01000193u;

__global__ void __launch_bounds__(kThreads)
cachekey_hash_kernel(const uint32_t* __restrict__ tokens,
                     uint32_t* __restrict__ out, int n_rows, int n_cols) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const uint32_t* t = tokens + static_cast<size_t>(row) * n_cols;
  uint32_t h0 = kFnvOffset;
  uint32_t h1 = kLane2Offset;
  for (int i = 0; i < n_cols; ++i) {
    const uint32_t word = __ldg(t + i);
#pragma unroll
    for (int shift = 0; shift < 32; shift += 8) {
      const uint32_t byte = (word >> shift) & 0xFFu;
      h0 = (h0 ^ byte) * kFnvPrime;
      h1 = (h1 ^ byte) * kFnvPrime;
    }
  }
  out[2 * static_cast<size_t>(row)] = h0;
  out[2 * static_cast<size_t>(row) + 1] = h1;
}

}  // namespace

// tokens [n_rows, n_cols] int32 row-major on `device`; out [n_rows, 2] of
// 32-bit words is written on `stream`.  Returns the CUDA error code of the
// launch (0 on success); does not synchronise.
extern "C" int cachekey_hash_u32(const void* tokens, void* out, int n_rows,
                                 int n_cols, int device, void* stream) {
  if (n_rows < 1 || n_cols < 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int blocks = (n_rows + kThreads - 1) / kThreads;
  cachekey_hash_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(tokens), static_cast<uint32_t*>(out),
      n_rows, n_cols);
  return cudaGetLastError();
}
