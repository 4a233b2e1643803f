// Softmax of per-edge logits over each CSR row, in float32, and its
// vector-Jacobian product: seg_softmax_fwd_f32 and seg_softmax_bwd_f32.
//
// For a CSR row r with edges e in [ptr[r], ptr[r+1]) and a per-edge mask
// k_e (all true when no mask is given):
//
//   forward   m_r = max_{k_e} l_e,  s_r = sum_{k_e} exp(l_e - m_r),
//             lse[r] = m_r + log(max(s_r, 1e-30)),
//             att[e] = k_e ? exp(l_e - lse[r]) : 0
//   backward  rs_r = sum_e att_e g_e,   dl[e] = att_e g_e - att_e rs_r
//
// A row with no unmasked edge has m = NEG (-1e30) and s = 0.  Slots from
// n_edges = ptr[n_rows] up to n_out (the graph's pads) are written as 0.
//
// Replaces three TPU kernels of msha_gnn_tpu/ops/pallas/softmax.py:
//   * _stats_kernel: the online (m, s) per row over chunk visits;
//   * _expand_kernel: a per-row value (lse forward, rs backward) to the
//     row's edges;
//   * _rowsum_kernel: per-edge values to per-row sums (rs).
// There each step is its own grid, because per-row state lives in VMEM
// across a block's chunk visits and row values reach the edges by one-hot
// selects.  Here one block owns one row and does all of it: the row's
// logits are contiguous, so both passes are coalesced loads, and lse or rs
// stays in a register between them.
//
// The re-mask hazard of softmax.py:73-78: masked edges take no part in the
// statistics at all (they are not merely set to NEG), so a fully masked row
// keeps s = 0 rather than summing exp(NEG - NEG) = 1 per edge.
//
// Bound: bytes (the pointer, the logits and the mask once, att and lse
// written once; the backward reads att and g and writes dl).  The exp per
// edge is far below the card's rate.
//
// Design (simple and right first): one block per row, n_warps warps (1..8,
// the caller's choice from the row lengths).  Thread t takes the row's
// edges t, t + blockDim, ... and keeps its own online (m, s) or partial sum;
// the warp merges by a shuffle tree, and the warps' results are merged in
// a fixed order in shared memory.  Deterministic, no atomics.  Blocks past
// the last row zero the pad slots.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// (m, s) merged with (m2, s2); both may be (NEG, 0).
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2) {
  const float m_new = fmaxf(m, m2);
  s = s * expf(m - m_new) + s2 * expf(m2 - m_new);
  m = m_new;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Blocks >= n_rows write zeros over the pad slots [n_edges, n_out).
__device__ __forceinline__ void zero_pads(float* __restrict__ out,
                                          int n_rows, int n_edges, int n_out) {
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) - n_rows) * blockDim.x + threadIdx.x +
      n_edges;
  if (i < n_out) out[i] = 0.0f;
}

template <bool kMasked>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
seg_softmax_fwd_kernel(const int* __restrict__ ptr,
                       const float* __restrict__ logits,
                       const uint8_t* __restrict__ mask,
                       float* __restrict__ att, float* __restrict__ lse,
                       int n_rows, int n_edges, int n_out) {
  __shared__ float m_w[kMaxWarps];
  __shared__ float s_w[kMaxWarps];
  if (static_cast<int>(blockIdx.x) >= n_rows) {
    zero_pads(att, n_rows, n_edges, n_out);
    return;
  }
  const int row = blockIdx.x;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int n_warps = blockDim.x / kWarp;
  const int begin = ptr[row];
  const int end = ptr[row + 1];
  float m = kNeg;
  float s = 0.0f;
  for (int e = begin + threadIdx.x; e < end; e += blockDim.x) {
    if (kMasked && !mask[e]) continue;
    const float l = __ldg(logits + e);
    const float m_new = fmaxf(m, l);
    s = s * expf(m - m_new) + expf(l - m_new);
    m = m_new;
  }
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2) {
    const float m2 = __shfl_xor_sync(kFull, m, o);
    const float s2 = __shfl_xor_sync(kFull, s, o);
    merge(m, s, m2, s2);
  }
  if (lane == 0) {
    m_w[warp] = m;
    s_w[warp] = s;
  }
  __syncthreads();
  m = m_w[0];
  s = s_w[0];
  for (int k = 1; k < n_warps; ++k) merge(m, s, m_w[k], s_w[k]);
  const float row_lse = m + logf(fmaxf(s, 1e-30f));
  if (threadIdx.x == 0) lse[row] = row_lse;
  for (int e = begin + threadIdx.x; e < end; e += blockDim.x) {
    const bool keep = !kMasked || mask[e];
    att[e] = keep ? expf(__ldg(logits + e) - row_lse) : 0.0f;
  }
}

__global__ void __launch_bounds__(kMaxWarps * kWarp)
seg_softmax_bwd_kernel(const int* __restrict__ ptr,
                       const float* __restrict__ att,
                       const float* __restrict__ g, float* __restrict__ dl,
                       int n_rows, int n_edges, int n_out) {
  __shared__ float rs_w[kMaxWarps];
  if (static_cast<int>(blockIdx.x) >= n_rows) {
    zero_pads(dl, n_rows, n_edges, n_out);
    return;
  }
  const int row = blockIdx.x;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int n_warps = blockDim.x / kWarp;
  const int begin = ptr[row];
  const int end = ptr[row + 1];
  float t = 0.0f;
  for (int e = begin + threadIdx.x; e < end; e += blockDim.x) {
    t = fmaf(__ldg(att + e), __ldg(g + e), t);
  }
  t = warp_sum(t);
  if (lane == 0) rs_w[warp] = t;
  __syncthreads();
  float rs = rs_w[0];
  for (int k = 1; k < n_warps; ++k) rs += rs_w[k];
  for (int e = begin + threadIdx.x; e < end; e += blockDim.x) {
    const float a = __ldg(att + e);
    const float ag = a * __ldg(g + e);
    dl[e] = ag - a * rs;
  }
}

bool bad_args(int n_rows, int n_edges, int n_out, int n_warps) {
  return n_rows <= 0 || n_edges < 0 || n_out < n_edges || n_warps < 1 ||
         n_warps > kMaxWarps;
}

// Blocks: one per row, then enough to zero the pad slots.
unsigned grid_for(int n_rows, int n_edges, int n_out, int threads) {
  const int64_t pads = static_cast<int64_t>(n_out) - n_edges;
  return static_cast<unsigned>(n_rows + (pads + threads - 1) / threads);
}

}  // namespace

// Launch on `stream`; neither synchronises.  ptr [n_rows + 1] int32 with
// n_edges = ptr[n_rows]; per-edge arrays [n_out] float32 (the mask uint8,
// or null for none) with n_out >= n_edges; lse [n_rows].  Each returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int seg_softmax_fwd_f32(const int* ptr, const float* logits,
                                   const uint8_t* mask, float* att,
                                   float* lse, int n_rows, int n_edges,
                                   int n_out, int n_warps,
                                   cudaStream_t stream) {
  if (bad_args(n_rows, n_edges, n_out, n_warps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = n_warps * kWarp;
  const unsigned grid = grid_for(n_rows, n_edges, n_out, threads);
  if (mask != nullptr) {
    seg_softmax_fwd_kernel<true><<<grid, threads, 0, stream>>>(
        ptr, logits, mask, att, lse, n_rows, n_edges, n_out);
  } else {
    seg_softmax_fwd_kernel<false><<<grid, threads, 0, stream>>>(
        ptr, logits, mask, att, lse, n_rows, n_edges, n_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int seg_softmax_bwd_f32(const int* ptr, const float* att,
                                   const float* g, float* dl, int n_rows,
                                   int n_edges, int n_out, int n_warps,
                                   cudaStream_t stream) {
  if (bad_args(n_rows, n_edges, n_out, n_warps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = n_warps * kWarp;
  seg_softmax_bwd_kernel<<<grid_for(n_rows, n_edges, n_out, threads), threads,
                           0, stream>>>(ptr, att, g, dl, n_rows, n_edges,
                                        n_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* seg_softmax_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
