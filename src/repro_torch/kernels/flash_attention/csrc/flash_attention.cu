// Flash attention forward (online softmax, GQA, causal), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `flash_attention` of the reference package
// (src/repro/kernels/flash_attention/kernel.py:87, pallas_call at :114).  It
// computes the same function: for q [B, H, Sq, hd] and k, v [B, K, Sk, hd]
// (H a multiple of K, query head h reading KV head h / (H / K)),
//
//   out[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, h / G, j] / sqrt(hd))
//                        * v[b, h / G, j]
//
// with the online-softmax state (m, l, acc) in fp32 and the output cast to
// q's dtype once at the end.  As in the reference kernel, keys at or past
// sk_valid are masked, and if causal, key j is masked for query row i when
// j > i + q_offset (by default sk_valid = Sk and q_offset = Sk - Sq: the last
// query sees the last key).  A key row's stride stays the tensor's Sk, so a
// decode step reads a preallocated cache of Sk rows, sk_valid of them filled,
// in place; every loop stops at sk_valid.  The reference pads Sk to its block
// size and masks keys past the true Sk; nothing is padded here, so that mask
// is the tile's ragged tail.  A masked key gets
// probability 0: the "simt" path sets its score to NEG_INF = -1e30 as the
// reference does (kernel.py:32, :67), the other two paths to -inf with the
// running max starting at -1e30.  For every row with at least one valid key
// that gives the softmax over its valid keys, as the reference does.  A
// causal row with no valid key (Sq > Sk) averages the keys of the tiles it
// runs in the reference, so it depends on the block shape, and is NaN in the
// reference's oracle; every path here writes 0 there.
//
// What bounds it on an H100: at prefill (smollm-360m, B = 1, S = 4,096,
// H = 15, K = 5, hd = 64, bf16, causal) the 32 GFLOP of the two products
// against 9.4 MB of q, k, v and out: operations, 33 us at the tensor cores'
// 989 TFLOP/s.  At decode (B = 128, Sq = 1, Sk = 32,768) the 5.4 GB of K and
// V: bytes, 1.6 ms at 3.35 TB/s.  So there are three paths, which the
// wrapper picks with kernel.py's path_for:
//
// * "wgmma" (wgmma.cuh): bf16, hd 64 or 128, more than 16 query rows per KV
//   head.  Tensor cores: a warp-specialised CTA per 128 query rows of one
//   head, a producer warp feeding K/V tiles of 128 keys through TMA into a
//   ring of shared memory, two consumer warpgroups running S = Q.K^T and
//   O += P.V with wgmma, P rounded to bf16 in registers (as the reference's
//   oracle rounds its probabilities), l summed from the fp32 P.
// * "decode" (decode.cuh): at most 16 query rows per KV head, f32 or bf16.
//   Bytes: the key axis split across blocks so that the card fills, 16-byte
//   loads with the next chunk in flight, partial (m, l, acc) merged by a
//   second kernel.  P stays fp32.
// * "simt" (this file): everything else -- f32 prefill (TF32 is opt-in in
//   this repo, so f32 stays off the tensor cores) and bf16 at other head
//   sizes.  Scalar fp32, no tensor cores, no TMA, no pipelining:
//   - one block of 8 warps per (batch, KV head, tile of 64 query rows),
//     where the rows of a KV head are its G query heads' rows interleaved,
//     row r = i * G + g for query position i and head kv_head * G + g: the G
//     heads that share a KV head read each K/V tile once, and repeated KV
//     heads are never materialised;
//   - K and V tiles of 64 keys are staged in shared memory as fp32 (K rows
//     padded to an odd stride, so that lane j reading key j's column c hits
//     a bank of its own);
//   - a warp owns 8 of the block's rows, interleaved across warps; lane j
//     scores keys j and j + 32 of the tile for its rows, the row max and sum
//     go through warp shuffles, and the probabilities go through shared
//     memory to the PV product, where lane j owns output columns j, j + 32,
//     j + 64, j + 96;
//   - causal tiles past the block's last query row are skipped.
//
// All three mask the ragged edges themselves; nothing is padded.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "decode.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;   // query rows per block
constexpr int kKeys = 64;                      // keys per K/V tile
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// Shared memory of one block, in floats, at head dimension hd.
__host__ __device__ inline size_t smem_floats(int hd) {
  return static_cast<size_t>(kRows) * hd +
         static_cast<size_t>(kKeys) * (hd | 1) +
         static_cast<size_t>(kKeys) * hd + static_cast<size_t>(kRows) * kKeys;
}

// NC = ceil(hd / 32): the output columns a lane owns.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int K, int Sq, int Sk, int sk_valid, int q_offset,
                       int hd, float scale, int causal) {
  extern __shared__ __align__(16) float smem[];
  const int ks = hd | 1;                        // odd row stride of k_s
  float* q_s = smem;                            // [kRows][hd]
  float* k_s = q_s + kRows * hd;                // [kKeys][ks]
  float* v_s = k_s + kKeys * ks;                // [kKeys][hd]
  float* p_s = v_s + kKeys * hd;                // [kRows][kKeys]

  const int G = H / K;
  const int b = blockIdx.z, kv_head = blockIdx.y;
  const int n_rows = Sq * G;
  const int row0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // this warp's rows are row0 + i * kWarps + warp for i < n_mine
  const int left = n_rows - row0 - warp;
  const int n_mine =
      left <= 0 ? 0 : min(kRowsPerWarp, (left + kWarps - 1) / kWarps);

  int kv_end = sk_valid;
  if (causal) {
    const int last = min(row0 + kRows, n_rows) - 1;
    kv_end = max(0, min(kv_end, last / G + q_offset + 1));
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NC];
  int qpos[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.0f;
    qpos[i] = 0;
    if (i < n_mine) {
      const int r = row0 + i * kWarps + warp;
      const int qi = r / G, g = r - qi * G;
      qpos[i] = qi + q_offset;
      const T* q_row =
          q + ((static_cast<size_t>(b) * H + kv_head * G + g) * Sq + qi) * hd;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int c = lane + 32 * n;
        if (c < hd) q_s[(i * kWarps + warp) * hd + c] = to_float(q_row[c]);
      }
    }
  }

  const T* k_head = k + (static_cast<size_t>(b) * K + kv_head) * Sk * hd;
  const T* v_head = v + (static_cast<size_t>(b) * K + kv_head) * Sk * hd;
  for (int k0 = 0; k0 < kv_end; k0 += kKeys) {
    // stage the tile: warp w loads keys w, w + 8, ...; lanes across columns
#pragma unroll
    for (int jj = 0; jj < kKeys / kWarps; ++jj) {
      const int j = warp + kWarps * jj;
      const bool in = k0 + j < sk_valid;
      const size_t at = static_cast<size_t>(k0 + j) * hd;
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int c = lane + 32 * n;
        if (c < hd) {
          k_s[j * ks + c] = in ? to_float(__ldg(k_head + at + c)) : 0.0f;
          v_s[j * hd + c] = in ? to_float(__ldg(v_head + at + c)) : 0.0f;
        }
      }
    }
    __syncthreads();

    if (n_mine > 0) {
      // scores of keys k0 + lane and k0 + lane + 32 for this warp's rows
      float s[kRowsPerWarp][2];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) s[i][0] = s[i][1] = 0.0f;
      for (int c = 0; c < hd; ++c) {
        const float ka = k_s[lane * ks + c];
        const float kb = k_s[(lane + 32) * ks + c];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          if (i < n_mine) {
            const float qv = q_s[(i * kWarps + warp) * hd + c];
            s[i][0] = fmaf(qv, ka, s[i][0]);
            s[i][1] = fmaf(qv, kb, s[i][1]);
          }
        }
      }
      const int ja = k0 + lane, jb = k0 + lane + 32;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        if (i < n_mine) {
          const bool va = ja < sk_valid && (!causal || ja <= qpos[i]);
          const bool vb = jb < sk_valid && (!causal || jb <= qpos[i]);
          const float xa = va ? s[i][0] * scale : kNegInf;
          const float xb = vb ? s[i][1] * scale : kNegInf;
          const float m_new = fmaxf(m[i], warp_max(fmaxf(xa, xb)));
          // 0 for a masked key even while the row has seen no valid key
          // (m_new = -1e30), so such a row keeps l = 0 and writes 0
          const float pa = va ? expf(xa - m_new) : 0.0f;
          const float pb = vb ? expf(xb - m_new) : 0.0f;
          const float alpha = expf(m[i] - m_new);
          l[i] = l[i] * alpha + warp_sum(pa + pb);
          m[i] = m_new;
          float* p_row = p_s + (i * kWarps + warp) * kKeys;
          p_row[lane] = pa;
          p_row[lane + 32] = pb;
#pragma unroll
          for (int n = 0; n < NC; ++n) acc[i][n] *= alpha;
        }
      }
      __syncwarp();
      // keys at or past kv_end are masked for every row: p is 0 there
      const int n_keys = min(kKeys, kv_end - k0);
      for (int j = 0; j < n_keys; ++j) {
        float vv[NC];
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const int c = lane + 32 * n;
          vv[n] = c < hd ? v_s[j * hd + c] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          if (i < n_mine) {
            const float p = p_s[(i * kWarps + warp) * kKeys + j];
#pragma unroll
            for (int n = 0; n < NC; ++n) acc[i][n] = fmaf(p, vv[n], acc[i][n]);
          }
        }
      }
    }
    __syncthreads();   // the next tile overwrites k_s and v_s
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (i < n_mine) {
      const int r = row0 + i * kWarps + warp;
      const int qi = r / G, g = r - qi * G;
      T* o_row =
          out + ((static_cast<size_t>(b) * H + kv_head * G + g) * Sq + qi) * hd;
      const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int c = lane + 32 * n;
        if (c < hd) o_row[c] = from_float<T>(acc[i][n] / lc);
      }
    }
  }
}

template <typename T, int NC>
cudaError_t launch_nc(const void* q, const void* k, const void* v, void* out,
                      int B, int H, int K, int Sq, int Sk, int sk_valid,
                      int q_offset, int hd, float scale, int causal,
                      cudaStream_t stream) {
  const size_t smem = smem_floats(hd) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long rows = static_cast<long long>(Sq) * (H / K);
  const dim3 grid(static_cast<unsigned>((rows + kRows - 1) / kRows), K, B);
  flash_attention_kernel<T, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, K, Sq, Sk, sk_valid,
      q_offset, hd, scale, causal);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int K, int Sq, int Sk, int sk_valid, int q_offset, int hd,
           float scale, int causal, int device, void* stream) {
  if (B < 1 || B > 65535 || K < 1 || K > 65535 || H < K || H % K != 0 ||
      Sq < 1 || Sk < 0 || sk_valid < 0 || sk_valid > Sk || hd < 1 ||
      hd > 128 ||
      static_cast<long long>(Sq) * (H / K) >= (1LL << 31)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const decltype(&launch_nc<T, 1>) by_nc[] = {
      launch_nc<T, 1>, launch_nc<T, 2>, launch_nc<T, 3>, launch_nc<T, 4>};
  return by_nc[(hd + 31) / 32 - 1](q, k, v, out, B, H, K, Sq, Sk, sk_valid,
                                   q_offset, hd, scale, causal, s);
}

}  // namespace

// q [B, H, Sq, hd], k and v [B, K, Sk, hd] row-major on `device`, one dtype;
// out [B, H, Sq, hd] in that dtype is written on `stream`.  Keys at or past
// sk_valid (0 <= sk_valid <= Sk) are masked; if causal, key j is masked for
// query row i when j > i + q_offset.  Returns the CUDA error code of the
// launch (0 on success); does not synchronise.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* out, int B, int H, int K, int Sq,
                                   int Sk, int sk_valid, int q_offset, int hd,
                                   float scale, int causal, int device,
                                   void* stream) {
  return launch<float>(q, k, v, out, B, H, K, Sq, Sk, sk_valid, q_offset, hd,
                       scale, causal, device, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int B, int H,
                                    int K, int Sq, int Sk, int sk_valid,
                                    int q_offset, int hd, float scale,
                                    int causal, int device, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, H, K, Sq, Sk, sk_valid,
                               q_offset, hd, scale, causal, device, stream);
}

// The "wgmma" path: bf16 q, k, v, out as above, hd 64 or 128,
// 1 <= sk_valid <= Sk, and 16-byte aligned q, k and v (TMA reads them).
extern "C" int flash_attention_wgmma_bf16(const void* q, const void* k,
                                          const void* v, void* out, int B,
                                          int H, int K, int Sq, int Sk,
                                          int sk_valid, int q_offset, int hd,
                                          float scale, int causal, int device,
                                          void* stream) {
  if (B < 1 || K < 1 || H < K || H % K != 0 || Sq < 1 || sk_valid < 1 ||
      sk_valid > Sk || (hd != 64 && hd != 128) ||
      static_cast<long long>((Sq + wg::kRows - 1) / wg::kRows) * B * H >=
          (1LL << 31) ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hd == 64 ? wg::launch<64>(q, k, v, out, B, H, K, Sq, Sk, sk_valid,
                                   q_offset, scale, causal, s)
                  : wg::launch<128>(q, k, v, out, B, H, K, Sq, Sk, sk_valid,
                                    q_offset, scale, causal, s);
}

// The "decode" path: G * Sq <= 16 query rows per KV head, hd * (bytes of the
// dtype) a power-of-two multiple of 16 up to 512.  The sk_valid keys are cut
// into n_splits splits of `per` keys; with more than one, part_ml [B, K,
// n_splits, G * Sq, 2] and part_acc [B, K, n_splits, G * Sq, hd] (fp32) take
// the partial states and a second kernel merges them into out.
template <typename T>
int decode_entry(const void* q, const void* k, const void* v, void* out,
                 void* part_ml, void* part_acc, int B, int H, int K, int Sq,
                 int Sk, int sk_valid, int q_offset, int hd, float scale,
                 int causal, int n_splits, int per, int device,
                 void* stream) {
  if (B < 1 || B > 65535 || K < 1 || K > 65535 || H < K || H % K != 0 ||
      Sq < 1 || sk_valid > Sk)
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return dec::launch<T>(q, k, v, out, static_cast<float*>(part_ml),
                        static_cast<float*>(part_acc), B, H, K, Sq, Sk,
                        sk_valid, q_offset, hd, scale, causal, n_splits, per,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_decode_f32(
    const void* q, const void* k, const void* v, void* out, void* part_ml,
    void* part_acc, int B, int H, int K, int Sq, int Sk, int sk_valid,
    int q_offset, int hd, float scale, int causal, int n_splits, int per,
    int device, void* stream) {
  return decode_entry<float>(q, k, v, out, part_ml, part_acc, B, H, K, Sq, Sk,
                             sk_valid, q_offset, hd, scale, causal, n_splits,
                             per, device, stream);
}

extern "C" int flash_attention_decode_bf16(
    const void* q, const void* k, const void* v, void* out, void* part_ml,
    void* part_acc, int B, int H, int K, int Sq, int Sk, int sk_valid,
    int q_offset, int hd, float scale, int causal, int n_splits, int per,
    int device, void* stream) {
  return decode_entry<__nv_bfloat16>(q, k, v, out, part_ml, part_acc, B, H, K,
                                     Sq, Sk, sk_valid, q_offset, hd, scale,
                                     causal, n_splits, per, device, stream);
}
