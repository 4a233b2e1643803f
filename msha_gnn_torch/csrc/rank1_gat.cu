// Fused rank-1 GAT layer with a destination-linear logit, in float32:
// the forward r1l_fwd_f32 and its recompute backward r1l_bwd_f32.
//
// For a CSR graph (row r has edges e in [ptr[r], ptr[r+1]), j = col[e]):
//
//   t_e   = <x[j], a>                      (computed here, per edge)
//   pre_e = c[r] + t_e,   l_e = leaky(pre_e, slope)
//   p_e   = exp(l_e - max_row l)           (softmax stats over UNdropped p)
//   k_e   = keep scale of slot e: 1/(1-rate) if kept, 0 if dropped, 1 at rate 0
//   out[r] = sum_e p_e k_e x[j] / sum_e p_e,   lse[r] = max + log(sum p)
//
// An empty row gets out = 0 and lse = NEG (-1e30).
//
// Replaces two TPU kernels of msha_gnn_tpu/ops/pallas/rank1_gat.py:
//   * _r1l_fwd_kernel (forward, above);
//   * _r1l_bwd_kernel (backward): for each edge
//       att_e = exp(l_e - lse[r]) (0 where lse[r] <= NEG/2),  q_e = att_e k_e,
//       dl_e  = q_e <gout[r], x[j]> - att_e <gout[r], out[r]>,
//       dpre_e = dl_e * (pre_e >= 0 ? 1 : slope),
//       z[e]  = q_e gout[r] + dpre_e a          (CSR order; dx = reduce of z
//                                                by column, done by the
//                                                caller with csr_spmm_f32)
//       dc[r] = sum_{e in r} dpre_e,   da = sum_all e dpre_e x[j].
// The TPU kernels walk 128-row blocks with one-hot MXU reduces and a bf16
// hi/lo split; none of that carries over.  Here the work is plain f32.
//
// The keep mask is a pure function of (seed, slot) with slot = e, the
// edge's index in the padded CSR array: the murmur3 finalizer of
// _hash01 (rank1_gat.py:66-82) in uint32 arithmetic (wrapping, logical
// shifts), bit for bit.  Forward and backward hash the same slots, so they
// see the same mask and no mask is stored.
//
// Bound.  Forward: operations at the linkpred shapes (4 E d flops against
// a few MB of bytes, x staying in L2).  Backward: bytes, the E x d write
// of z.  Both kernels sit far above their bound: the simple design is one
// block per row, which serialises long rows.
//
// Design (simple and right first): one block per row, as csr_spmm_f32.
// Each warp takes every n_warps-th group of kUnroll edges, so the loads of
// a group are in flight together; lanes run over 32-wide feature tiles, so
// any d works.  A warp keeps its own online-softmax state (m, s) and
// accumulates into its own row of shared memory; the warps merge in a
// fixed order.  No float atomics anywhere, so results are deterministic.
// da: each block writes its row's partial, and a second grid in the same
// entry point adds the partials in a fixed order (full f32, as the TPU
// kernel keeps it on purpose, rank1_gat.py:384-388).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;
constexpr int kUnroll = 4;
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

// _hash01 + _keep_scale of rank1_gat.py, on uint32.
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

// Dynamic shared memory: a[d] | acc[n_warps][d] | m[n_warps] | s[n_warps]
template <bool kDrop>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
r1l_fwd_kernel(const int* __restrict__ ptr, const int* __restrict__ col,
               const float* __restrict__ c, const float* __restrict__ a,
               const float* __restrict__ x, const int* __restrict__ seed_ptr,
               float rate, float scale, float slope, float* __restrict__ out,
               float* __restrict__ lse, int d) {
  extern __shared__ float smem[];
  const int n_warps = blockDim.x / kWarp;
  float* a_s = smem;
  float* acc_all = a_s + d;
  float* m_s = acc_all + n_warps * d;
  float* s_s = m_s + n_warps;
  const int row = blockIdx.x;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  float* acc = acc_all + warp * d;
  for (int f = threadIdx.x; f < d; f += blockDim.x) a_s[f] = a[f];
  for (int f = lane; f < d; f += kWarp) acc[f] = 0.0f;
  __syncthreads();

  const int begin = ptr[row];
  const int end = ptr[row + 1];
  const float c_row = c[row];
  const uint32_t seed = kDrop ? static_cast<uint32_t>(seed_ptr[0]) : 0u;
  float m = kNeg;
  float s = 0.0f;
  for (int e0 = begin + warp * kUnroll; e0 < end;
       e0 += n_warps * kUnroll) {
    int64_t xrow[kUnroll];
    float t[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u;
      xrow[u] = e < end ? static_cast<int64_t>(__ldg(col + e)) * d : -1;
      t[u] = 0.0f;
    }
    for (int f = lane; f < d; f += kWarp) {
      const float af = a_s[f];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (xrow[u] >= 0) t[u] = fmaf(__ldg(x + xrow[u] + f), af, t[u]);
      }
    }
    float l[kUnroll];
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      t[u] = warp_sum(t[u]);
      l[u] = xrow[u] >= 0 ? leaky(c_row + t[u], slope) : kNeg;
      m_new = fmaxf(m_new, l[u]);
    }
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
  if (lane == 0) {
    m_s[warp] = m;
    s_s[warp] = s;
  }
  __syncthreads();

  // merge the warps' (m, s, acc) in warp order
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

// Dynamic shared memory: a[d] | g[d] | da[n_warps][d] | dc[n_warps]
template <bool kDrop>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
r1l_bwd_kernel(const int* __restrict__ ptr, const int* __restrict__ col,
               const float* __restrict__ c, const float* __restrict__ a,
               const float* __restrict__ x, const float* __restrict__ gout,
               const float* __restrict__ out, const float* __restrict__ lse,
               const int* __restrict__ seed_ptr, float rate, float scale,
               float slope, float* __restrict__ z, float* __restrict__ dc,
               float* __restrict__ da_part, int d) {
  extern __shared__ float smem[];
  const int n_warps = blockDim.x / kWarp;
  float* a_s = smem;
  float* g_s = a_s + d;
  float* da_all = g_s + d;
  float* dc_s = da_all + n_warps * d;
  const int row = blockIdx.x;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int64_t row_off = static_cast<int64_t>(row) * d;
  float* da_acc = da_all + warp * d;
  for (int f = threadIdx.x; f < d; f += blockDim.x) {
    a_s[f] = a[f];
    g_s[f] = gout[row_off + f];
  }
  for (int f = lane; f < d; f += kWarp) da_acc[f] = 0.0f;
  __syncthreads();

  // <gout[r], out[r]>, by every warp (no extra barrier)
  float d_row = 0.0f;
  for (int f = lane; f < d; f += kWarp) {
    d_row = fmaf(g_s[f], out[row_off + f], d_row);
  }
  d_row = warp_sum(d_row);

  const int begin = ptr[row];
  const int end = ptr[row + 1];
  const float c_row = c[row];
  const float lse_row = lse[row];
  const bool live = lse_row > 0.5f * kNeg;
  const uint32_t seed = kDrop ? static_cast<uint32_t>(seed_ptr[0]) : 0u;
  float dc_w = 0.0f;
  for (int e0 = begin + warp * kUnroll; e0 < end;
       e0 += n_warps * kUnroll) {
    int64_t xrow[kUnroll];
    float t[kUnroll];
    float gx[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u;
      xrow[u] = e < end ? static_cast<int64_t>(__ldg(col + e)) * d : -1;
      t[u] = 0.0f;
      gx[u] = 0.0f;
    }
    for (int f = lane; f < d; f += kWarp) {
      const float af = a_s[f];
      const float gf = g_s[f];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (xrow[u] >= 0) {
          const float xv = __ldg(x + xrow[u] + f);
          t[u] = fmaf(xv, af, t[u]);
          gx[u] = fmaf(xv, gf, gx[u]);
        }
      }
    }
    float q[kUnroll];
    float dpre[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      t[u] = warp_sum(t[u]);
      gx[u] = warp_sum(gx[u]);
      const float pre = c_row + t[u];
      const bool ok = xrow[u] >= 0 && live;
      const float att = ok ? expf(leaky(pre, slope) - lse_row) : 0.0f;
      q[u] = kDrop ? att * keep_scale(static_cast<uint32_t>(e0 + u), seed,
                                      rate, scale)
                   : att;
      const float dl = q[u] * gx[u] - att * d_row;
      dpre[u] = xrow[u] >= 0 ? dl * (pre >= 0.0f ? 1.0f : slope) : 0.0f;
      dc_w += dpre[u];
    }
    for (int f = lane; f < d; f += kWarp) {
      const float af = a_s[f];
      const float gf = g_s[f];
      float v = da_acc[f];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (xrow[u] >= 0) {
          const int64_t e = e0 + u;
          z[e * d + f] = fmaf(q[u], gf, dpre[u] * af);
          v = fmaf(dpre[u], __ldg(x + xrow[u] + f), v);
        }
      }
      da_acc[f] = v;
    }
  }
  if (lane == 0) dc_s[warp] = dc_w;
  __syncthreads();
  for (int f = threadIdx.x; f < d; f += blockDim.x) {
    float v = 0.0f;
    for (int k = 0; k < n_warps; ++k) v += da_all[k * d + f];
    da_part[row_off + f] = v;
  }
  if (threadIdx.x == 0) {
    float v = 0.0f;
    for (int k = 0; k < n_warps; ++k) v += dc_s[k];
    dc[row] = v;
  }
}

// da[f] = sum_r da_part[r, f]: one block per 32 features, 32 warps striding
// over the rows, then the warps' sums in warp order.
__global__ void __launch_bounds__(kWarp * kWarp)
r1l_da_reduce_kernel(const float* __restrict__ da_part, float* __restrict__ da,
                     int n_rows, int d) {
  __shared__ float partial[kWarp][kWarp];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int f = blockIdx.x * kWarp + lane;
  float v = 0.0f;
  if (f < d) {
    for (int r = warp; r < n_rows; r += kWarp) {
      v += da_part[static_cast<int64_t>(r) * d + f];
    }
  }
  partial[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && f < d) {
    float sum = 0.0f;
    for (int k = 0; k < kWarp; ++k) sum += partial[k][lane];
    da[f] = sum;
  }
}

__global__ void r1l_keep_scale_kernel(const int* __restrict__ seed_ptr,
                                      float rate, float scale, int n,
                                      float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    out[i] = keep_scale(static_cast<uint32_t>(i),
                        static_cast<uint32_t>(seed_ptr[0]), rate, scale);
  }
}

size_t fwd_smem(int d, int n_warps) {
  return sizeof(float) * (static_cast<size_t>(d) * (1 + n_warps) + 2 * n_warps);
}

size_t bwd_smem(int d, int n_warps) {
  return sizeof(float) * (static_cast<size_t>(d) * (2 + n_warps) + n_warps);
}

constexpr size_t kMaxSmem = 48 * 1024;

bool bad_shape(int n_rows, int d, int n_warps) {
  return n_rows <= 0 || d <= 0 || n_warps < 1 || n_warps > kMaxWarps;
}

}  // namespace

// All entry points launch on `stream`, do not synchronise, and return
// cudaGetLastError() after their launches (0 = launched).  `seed` is a
// device pointer to one int32, read only when rate > 0.  `scale` is the
// kept edges' factor 1/(1-rate), given by the caller in float32.

extern "C" int r1l_fwd_f32(const int* ptr, const int* col, const float* c,
                           const float* a, const float* x, const int* seed,
                           float rate, float scale, float slope, float* out,
                           float* lse, int n_rows, int d, int n_warps,
                           cudaStream_t stream) {
  if (bad_shape(n_rows, d, n_warps) || fwd_smem(d, n_warps) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = fwd_smem(d, n_warps);
  if (rate > 0.0f) {
    r1l_fwd_kernel<true><<<n_rows, n_warps * kWarp, smem, stream>>>(
        ptr, col, c, a, x, seed, rate, scale, slope, out, lse, d);
  } else {
    r1l_fwd_kernel<false><<<n_rows, n_warps * kWarp, smem, stream>>>(
        ptr, col, c, a, x, seed, rate, scale, slope, out, lse, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// Two grids: the per-row edge kernel (z, dc and da partials into
// `da_part` [n_rows, d]), then the fixed-order da reduce.
extern "C" int r1l_bwd_f32(const int* ptr, const int* col, const float* c,
                           const float* a, const float* x, const float* gout,
                           const float* out, const float* lse, const int* seed,
                           float rate, float scale, float slope, float* z,
                           float* dc, float* da_part, float* da, int n_rows,
                           int d, int n_warps, cudaStream_t stream) {
  if (bad_shape(n_rows, d, n_warps) || bwd_smem(d, n_warps) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = bwd_smem(d, n_warps);
  if (rate > 0.0f) {
    r1l_bwd_kernel<true><<<n_rows, n_warps * kWarp, smem, stream>>>(
        ptr, col, c, a, x, gout, out, lse, seed, rate, scale, slope, z, dc,
        da_part, d);
  } else {
    r1l_bwd_kernel<false><<<n_rows, n_warps * kWarp, smem, stream>>>(
        ptr, col, c, a, x, gout, out, lse, seed, rate, scale, slope, z, dc,
        da_part, d);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  r1l_da_reduce_kernel<<<(d + kWarp - 1) / kWarp, kWarp * kWarp, 0, stream>>>(
      da_part, da, n_rows, d);
  return static_cast<int>(cudaGetLastError());
}

// The keep scale of slots 0..n-1, by the kernels' own device function
// (for checking the mask against its plain version).
extern "C" int r1l_keep_scale_f32(const int* seed, float rate, float scale,
                                  int n, float* out, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  r1l_keep_scale_kernel<<<(n + 255) / 256, 256, 0, stream>>>(seed, rate, scale,
                                                             n, out);
  return static_cast<int>(cudaGetLastError());
}

// The largest warps per block (1..8) whose shared memory fits both kernels
// at feature width d; 0 when even one warp does not fit.
extern "C" int r1l_max_warps(int d) {
  for (int w = kMaxWarps; w >= 1; --w) {
    if (fwd_smem(d, w) <= kMaxSmem && bwd_smem(d, w) <= kMaxSmem) return w;
  }
  return 0;
}

extern "C" const char* r1l_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
