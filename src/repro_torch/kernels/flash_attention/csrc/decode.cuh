// The "decode" path of flash_attention: at most 16 query rows per KV head
// (a decode step, or a short chunk of queries) against a long cache, in
// float32 or bf16.  Included by flash_attention.cu; see the design note
// there.
//
// The work is bound by the bytes of K and V, so the design keeps many
// loads in flight and every SM busy:
// * blocks are (split of the key axis, KV head, batch); the wrapper picks
//   the splits so that about 32 blocks per SM run in all;
// * a block's 4 warps take interleaved chunks of its keys; LPK lanes hold
//   one key row with a 16-byte load each (8 lanes at hd 64 bf16, so a warp
//   covers 4 keys per load), and a chunk of U such loads is prefetched
//   into registers while the previous chunk is computed;
// * each lane keeps the block's R query rows (its VE columns of each,
//   pre-scaled by log2(e) / sqrt(hd)) in registers; a score is a partial
//   dot product reduced over the LPK lanes with shuffles; each key group
//   keeps its own online-softmax state (m, l, acc) per row in fp32, and P
//   stays fp32;
// * the key groups of a warp merge with shuffles, the warps of a block
//   through shared memory; with one split that merge writes the output,
//   else each split writes its partial (m, l, acc) to fp32 scratch and a
//   second kernel, combine_kernel, merges the splits.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace dec {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;

// 16 bytes of T as floats
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Folds state (m2, l2, acc2) into (m, l, acc); m in the log2 domain.
template <int VE>
__device__ __forceinline__ void fold(float& m, float& l, float (&acc)[VE],
                                     float m2, float l2,
                                     const float (&acc2)[VE]) {
  const float mx = fmaxf(m, m2);
  const float a = exp2f(m - mx), b = exp2f(m2 - mx);
  l = l * a + l2 * b;
#pragma unroll
  for (int e = 0; e < VE; ++e) acc[e] = acc[e] * a + acc2[e] * b;
  m = mx;
}

// Loads chunk `base` of U key steps: lane key kg of step u is key
// base + u * KPW + kg; keys at or past `end` read as zeros.
template <int LPK, int U>
__device__ __forceinline__ void load_chunk(const uint4* __restrict__ kp,
                                           const uint4* __restrict__ vp,
                                           int base, int end, int kg, int cl,
                                           uint4 (&kb)[U], uint4 (&vb)[U]) {
  constexpr int KPW = 32 / LPK;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = base + u * KPW + kg;
    if (j < end) {
      kb[u] = __ldg(kp + static_cast<size_t>(j) * LPK + cl);
      vb[u] = __ldg(vp + static_cast<size_t>(j) * LPK + cl);
    } else {
      kb[u] = make_uint4(0, 0, 0, 0);
      vb[u] = make_uint4(0, 0, 0, 0);
    }
  }
}

// R: query rows held (>= G * Sq, a power of two); LPK: lanes per key row
// (hd * sizeof(T) / 16); U: 16-byte loads per lane per chunk.
template <typename T, int LPK, int R, int U>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out,
              float* __restrict__ part_ml, float* __restrict__ part_acc,
              int H, int K, int Sq, int Sk, int sk_valid, int q_offset,
              float scale_log2, int causal, int per) {
  constexpr int VE = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int HD = LPK * VE;
  constexpr int KPW = 32 / LPK;        // keys per warp-wide load
  constexpr int CHUNK = U * KPW;       // keys per warp per chunk
  __shared__ float sm_m[kWarps][R], sm_l[kWarps][R];
  __shared__ float sm_acc[kWarps][R][HD];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int G = H / K, rows = G * Sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kg = lane / LPK, cl = lane % LPK;
  const int s0 = split * per, s1 = min(sk_valid, s0 + per);

  // this lane's columns of each row, pre-scaled; row r = i * G + g is query
  // i of head kvh * G + g, at key position i + q_offset
  float qv[R][VE];
  int qpos[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    qpos[r] = -1;   // a padding row sees no key
#pragma unroll
    for (int e = 0; e < VE; ++e) qv[r][e] = 0.0f;
    if (r < rows) {
      const int i = r / G, g = r - i * G;
      qpos[r] = causal ? i + q_offset : sk_valid;
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(
                                q + ((static_cast<size_t>(b) * H + kvh * G + g) *
                                         Sq + i) * HD) + cl);
      unpack(u, qv[r]);
#pragma unroll
      for (int e = 0; e < VE; ++e) qv[r][e] *= scale_log2;
    }
  }

  float m[R], l[R], acc[R][VE];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[r][e] = 0.0f;
  }

  const size_t head = (static_cast<size_t>(b) * K + kvh) * Sk * LPK;
  const uint4* kp = reinterpret_cast<const uint4*>(k) + head;
  const uint4* vp = reinterpret_cast<const uint4*>(v) + head;
  uint4 kb[U], vb[U];
  int base = s0 + warp * CHUNK;
  load_chunk<LPK, U>(kp, vp, base, s1, kg, cl, kb, vb);
  for (; base < s1; base += kWarps * CHUNK) {
    uint4 kn[U], vn[U];   // the next chunk, in flight during this one
    load_chunk<LPK, U>(kp, vp, base + kWarps * CHUNK, s1, kg, cl, kn, vn);

    float s[U][R];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VE];
      unpack(kb[u], kf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float d = 0.0f;
#pragma unroll
        for (int e = 0; e < VE; ++e) d = fmaf(qv[r][e], kf[e], d);
#pragma unroll
        for (int o = LPK / 2; o > 0; o >>= 1)
          d += __shfl_xor_sync(~0u, d, o);
        const int j = base + u * KPW + kg;
        s[u][r] = j < s1 && j <= qpos[r] ? d : -INFINITY;
      }
    }
    // one rescale per chunk: m over its U keys, then p = exp2(s - m)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][r]);
      const float alpha = exp2f(m[r] - mx);
      m[r] = mx;
      l[r] *= alpha;
#pragma unroll
      for (int e = 0; e < VE; ++e) acc[r][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[VE];
      unpack(vb[u], vf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = exp2f(s[u][r] - m[r]);
        l[r] += p;
#pragma unroll
        for (int e = 0; e < VE; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kb[u] = kn[u];
      vb[u] = vn[u];
    }
  }

  // merge the key groups of the warp (lanes LPK apart hold the same columns)
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float acc2[VE];
#pragma unroll
      for (int e = 0; e < VE; ++e) acc2[e] = __shfl_xor_sync(~0u, acc[r][e], o);
      const float m2 = __shfl_xor_sync(~0u, m[r], o);
      const float l2 = __shfl_xor_sync(~0u, l[r], o);
      fold<VE>(m[r], l[r], acc[r], m2, l2, acc2);
    }
  }
  // then the warps, through shared memory
  if (kg == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int e = 0; e < VE; ++e) sm_acc[warp][r][cl * VE + e] = acc[r][e];
      if (cl == 0) {
        sm_m[warp][r] = m[r];
        sm_l[warp][r] = l[r];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * HD; idx += kThreads) {
    const int r = idx / HD, c = idx - r * HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float lt = 0.0f, at = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = exp2f(sm_m[w][r] - mx);
      lt += sm_l[w][r] * a;
      at += sm_acc[w][r][c] * a;
    }
    if (n_splits == 1) {
      const int i = r / G, g = r - i * G;
      store(out + ((static_cast<size_t>(b) * H + kvh * G + g) * Sq + i) * HD +
                c,
            lt > 0.0f ? at / lt : 0.0f);
    } else {
      const size_t at_row =
          ((static_cast<size_t>(b) * K + kvh) * n_splits + split) * rows + r;
      part_acc[at_row * HD + c] = at;
      if (c == 0) {
        part_ml[2 * at_row] = mx;
        part_ml[2 * at_row + 1] = lt;
      }
    }
  }
}

// Merges the splits' partial (m, l, acc) of one row per block, one output
// column per thread: Σ acc·2^(m - M) / Σ l·2^(m - M), 0 where l sums to 0.
template <typename T>
__global__ void combine_kernel(const float* __restrict__ part_ml,
                               const float* __restrict__ part_acc,
                               T* __restrict__ out, int H, int K, int Sq,
                               int n_splits, int hd) {
  const int r = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int rows = gridDim.x, c = threadIdx.x, G = H / K;
  const size_t row0 = (static_cast<size_t>(b) * K + kvh) * n_splits * rows + r;
  float mx = kNegInf;
  for (int s = 0; s < n_splits; ++s)
    mx = fmaxf(mx, part_ml[2 * (row0 + static_cast<size_t>(s) * rows)]);
  float lt = 0.0f, at = 0.0f;
  for (int s = 0; s < n_splits; ++s) {
    const size_t at_row = row0 + static_cast<size_t>(s) * rows;
    const float a = exp2f(part_ml[2 * at_row] - mx);
    lt += part_ml[2 * at_row + 1] * a;
    at += part_acc[at_row * hd + c] * a;
  }
  const int i = r / G, g = r - i * G;
  store(out + ((static_cast<size_t>(b) * H + kvh * G + g) * Sq + i) * hd + c,
        lt > 0.0f ? at / lt : 0.0f);
}

template <typename T, int LPK, int R>
cudaError_t launch_lpk_r(const void* q, const void* k, const void* v,
                         void* out, float* part_ml, float* part_acc, int B,
                         int H, int K, int Sq, int Sk, int sk_valid,
                         int q_offset, float scale_log2, int causal,
                         int n_splits, int per, cudaStream_t stream) {
  constexpr int U = R <= 4 ? 4 : R <= 8 ? 2 : 1;
  decode_kernel<T, LPK, R, U><<<dim3(n_splits, K, B), kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), part_ml, part_acc, H, K,
      Sq, Sk, sk_valid, q_offset, scale_log2, causal, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return err;
  constexpr int HD = LPK * 16 / static_cast<int>(sizeof(T));
  combine_kernel<T><<<dim3((H / K) * Sq, K, B), HD, 0, stream>>>(
      part_ml, part_acc, static_cast<T*>(out), H, K, Sq, n_splits, HD);
  return cudaGetLastError();
}

template <typename T, int LPK>
cudaError_t launch_lpk(const void* q, const void* k, const void* v, void* out,
                       float* part_ml, float* part_acc, int B, int H, int K,
                       int Sq, int Sk, int sk_valid, int q_offset,
                       float scale_log2, int causal, int n_splits, int per,
                       cudaStream_t stream) {
  const int rows = (H / K) * Sq;
  const auto fn = rows <= 4   ? launch_lpk_r<T, LPK, 4>
                  : rows <= 8 ? launch_lpk_r<T, LPK, 8>
                              : launch_lpk_r<T, LPK, 16>;
  return fn(q, k, v, out, part_ml, part_acc, B, H, K, Sq, Sk, sk_valid,
            q_offset, scale_log2, causal, n_splits, per, stream);
}

// Returns cudaErrorInvalidValue for a shape this path does not take.
template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* part_ml, float* part_acc, int B, int H, int K,
                   int Sq, int Sk, int sk_valid, int q_offset, int hd,
                   float scale, int causal, int n_splits, int per,
                   cudaStream_t stream) {
  const int bytes = hd * static_cast<int>(sizeof(T));
  if ((H / K) * Sq > 16 || sk_valid < 1 || sk_valid > Sk || hd > 128 ||
      bytes % 16 != 0 || n_splits < 1 || n_splits > 65535 || per < 1 ||
      static_cast<long long>(n_splits) * per < sk_valid ||
      (n_splits > 1 && (part_ml == nullptr || part_acc == nullptr)))
    return cudaErrorInvalidValue;
  decltype(&launch_lpk<T, 1>) fn = nullptr;
  switch (bytes / 16) {
    case 1: fn = launch_lpk<T, 1>; break;
    case 2: fn = launch_lpk<T, 2>; break;
    case 4: fn = launch_lpk<T, 4>; break;
    case 8: fn = launch_lpk<T, 8>; break;
    case 16: fn = launch_lpk<T, 16>; break;
    case 32:   // hd 128 in float32; bf16 stops at 16 lanes
      if constexpr (sizeof(T) == 4) fn = launch_lpk<T, 32>;
      break;
    default: break;
  }
  if (fn == nullptr) return cudaErrorInvalidValue;
  return fn(q, k, v, out, part_ml, part_acc, B, H, K, Sq, Sk, sk_valid,
            q_offset, scale * 1.4426950408889634f, causal, n_splits, per,
            stream);
}

}  // namespace dec
