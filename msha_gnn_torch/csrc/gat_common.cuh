// Device functions shared by the GAT kernels (rank1_gat.cu, flash_gat.cu,
// gat_runs.cuh, gat_fwd.cuh): the warp sum, the leaky ReLU and the dropout
// keep scale, so the keep mask's hash has one definition.
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

}  // namespace gat
