// Device functions shared by the GAT kernels (rank1_gat.cu, flash_gat.cu):
// the warp sum, the leaky ReLU, the dropout keep scale (so the keep mask's
// hash has one definition) and the online-softmax aggregation of one row
// (fold_group per group of edges, merge_row for the warps' states), which
// r1l_fwd_f32 and flash_fwd_f32 share; they differ only in where the
// logits come from.
//
// keep_scale is _hash01 + _keep_scale of msha_gnn_tpu/ops/pallas/
// rank1_gat.py:66-91 on uint32 (wrapping products, logical shifts), bit for
// bit.  Its slot is the edge's index in the CSR edge array, as the TPU
// kernels' cs[k] * E_CHUNK + lane is.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace gat {

constexpr int kWarp = 32;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float leaky(float pre, float slope) {
  return pre >= 0.0f ? pre : slope * pre;
}

// 1/(1-rate) (given as `scale`) where slot `slot` is kept, 0 where dropped.
__device__ __forceinline__ float keep_scale(uint32_t slot, uint32_t seed,
                                            float rate, float scale) {
  uint32_t h = slot * 0x9E3779B9u + seed;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  const float u = static_cast<float>(h & 0xFFFFFFu) * (1.0f / 16777216.0f);
  return u >= rate ? scale : 0.0f;
}

// Folds one group of kUnroll edges, slots e0.., into a warp's online
// softmax state: the running max m, the sum s of the undropped p and acc[d]
// (this warp's row of shared memory) += p k x[j].  xrow[u] = j * d, or -1
// past the row's end, where l[u] must be kNeg.
template <int kUnroll, bool kDrop>
__device__ __forceinline__ void fold_group(const float (&l)[kUnroll],
                                           const int64_t (&xrow)[kUnroll],
                                           int e0, uint32_t seed, float rate,
                                           float scale,
                                           const float* __restrict__ x,
                                           float* acc, int d, int lane,
                                           float& m, float& s) {
  float m_new = m;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) m_new = fmaxf(m_new, l[u]);
  const float rescale = expf(m - m_new);
  float w[kUnroll];
  float p_sum = 0.0f;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const float p = xrow[u] >= 0 ? expf(l[u] - m_new) : 0.0f;
    p_sum += p;
    w[u] = kDrop ? p * keep_scale(static_cast<uint32_t>(e0 + u), seed, rate,
                                  scale)
                 : p;
  }
  s = s * rescale + p_sum;
  m = m_new;
  for (int f = lane; f < d; f += kWarp) {
    float v = acc[f] * rescale;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (xrow[u] >= 0) v = fmaf(w[u], __ldg(x + xrow[u] + f), v);
    }
    acc[f] = v;
  }
}

// Merges the warps' states (m, s and their rows of acc_all [n_warps][d])
// in warp order: out[row] = acc / s, lse[row] = m + log s; an empty row
// gets 0 and kNeg.  Every thread of the block calls it.
__device__ __forceinline__ void merge_row(float m, float s,
                                          const float* acc_all, float* m_s,
                                          float* s_s, int row, int d,
                                          float* __restrict__ out,
                                          float* __restrict__ lse) {
  const int n_warps = blockDim.x / kWarp;
  if (threadIdx.x % kWarp == 0) {
    m_s[threadIdx.x / kWarp] = m;
    s_s[threadIdx.x / kWarp] = s;
  }
  __syncthreads();
  float m_row = kNeg;
  for (int k = 0; k < n_warps; ++k) m_row = fmaxf(m_row, m_s[k]);
  float s_row = 0.0f;
  for (int k = 0; k < n_warps; ++k) s_row += s_s[k] * expf(m_s[k] - m_row);
  const float inv = s_row > 0.0f ? 1.0f / s_row : 0.0f;
  for (int f = threadIdx.x; f < d; f += blockDim.x) {
    float v = 0.0f;
    for (int k = 0; k < n_warps; ++k) {
      v += acc_all[k * d + f] * expf(m_s[k] - m_row);
    }
    out[static_cast<int64_t>(row) * d + f] = s_row > 0.0f ? v * inv : 0.0f;
  }
  if (threadIdx.x == 0) lse[row] = s_row > 0.0f ? m_row + logf(s_row) : kNeg;
}

}  // namespace gat
