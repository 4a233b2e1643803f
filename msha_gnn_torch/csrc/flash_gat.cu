// Flash-GAT in float32: the softmax of given per-edge logits over each CSR
// row, the hashed attention dropout and the aggregation in one pass
// (flash_fwd_f32), and its recompute backward (flash_bwd_f32); and, from
// the same two kernels with the logits formed in-kernel, the generic
// rank-1 GAT (r1_fwd_f32, r1_bwd_f32; see below).
//
// For a CSR graph (row r has edges e in [ptr[r], ptr[r+1]), j = col[e]) and
// logits l [>= E] in CSR order:
//
//   p_e    = exp(l_e - max_row l)          (softmax stats over UNdropped p)
//   k_e    = keep scale of slot e: 1/(1-rate) if kept, 0 if dropped, 1 at
//            rate 0 (gat::keep_scale of gat_common.cuh, the hash of the
//            rank-1 kernels: slot = e, the raw CSR index, as the TPU
//            kernels' cs[k] * E_CHUNK + lane)
//   out[r] = sum_e p_e k_e x[j] / sum_e p_e,   lse[r] = max + log(sum p)
//
// An empty row gets out = 0 and lse = NEG (-1e30).  Backward, per edge:
//
//   att_e = exp(l_e - lse[r]), 0 where lse[r] <= NEG/2,   q_e = att_e k_e,
//   dl_e  = q_e <gout[r], x[j]> - att_e <gout[r], out[r]>
//
// with `out` the forward's output (dropout included).  The kernel writes dl
// and q, 2 floats an edge, with the pad slots [ptr[n], n_out) zeroed; the
// caller takes dx[j] = sum_{e: col_e = j} q_e gout[r_e], the transposed
// csr_spmm_f32 of gout weighted by q.
//
// Generic rank-1 GAT (kRank1, no dropout): the logits are
//
//   pre_e = c[r] + t[j],   l_e = leaky(pre_e, slope)
//
// with c [n_rows] per row and t [n_cols] per column, read per edge; the
// forward is the flash forward on them.  The backward writes att_e (as q)
// and dpre_e = dl_e * (pre_e >= 0 ? 1 : slope) (in dl's place), and
// dc[r] = sum_{e in r} dpre_e, summed in the row's block in a fixed order;
// the caller takes dx = the att-weighted transposed csr_spmm_f32 of gout
// and dt[j] = sum_{e: col_e = j} dpre_e.
//
// Replaces four TPU kernels:
//   * msha_gnn_tpu/ops/pallas/flash_gat.py:51 _flash_kernel, the forward
//     above;
//   * flash_gat.py:167 _flash_bwd_kernel, which writes dl and
//     z_e = q_e gout[r_e] ([E, d], reduced by column for dx afterwards).
//     Only the operator's function (dl, dx) is kept: z is not written;
//   * msha_gnn_tpu/ops/pallas/rank1_gat.py:94 _r1_fwd_kernel, the generic
//     rank-1 forward, whose t rides the row gather as an extra column;
//   * rank1_gat.py:160 _r1_bwd_kernel, which writes [z || dpre] ([E, d+1])
//     for one transpose reduce of dx and dt, and dc.  Here 2 floats an edge
//     (att, dpre), not d + 1: dx and dt are two reduces that read them.
// The TPU kernels walk 128-row visit blocks with one-hot MXU scatters and
// a bf16 hi/lo split; none of that carries over.  Here the work is plain
// f32.
//
// Bound, at the linkpred shapes (n 4,267, E 328,012, d 64): bytes.
// Forward 4.8 MB (col, logits, x once, out, ptr, lse) against 2 E d flops;
// backward 8.6 MB (adds gout, out and the dl, q writes).  The rank-1 forms
// read c and t (per node) in place of the E logits.  All sit far above it:
// one block per row serialises the 3,842-edge row.
//
// Design (simple and right first): one block per row, as r1l_fwd_f32.
// Each warp takes every n_warps-th group of kUnroll edges, so the loads of
// a group are in flight together; lanes run over 32-wide feature tiles, so
// any d works.  Forward: r1l_fwd_f32's online-softmax aggregation
// (gat::fold_group, gat::merge_row), fed with logits read from memory or,
// for the rank-1 form, formed from c and t (logit_of): a warp keeps its
// own state (m, s) and accumulates into its own row of shared memory; the
// warps merge in a fixed order.  Backward: the block holds gout[r] in
// shared memory, each warp forms <gout[r], out[r]> once, then one d-wide
// dot per edge; the rank-1 form's dc is a lane, warp, then warp-order sum.
// No float atomics, so results are deterministic.

#include <cuda_runtime.h>

#include <cstdint>

#include "gat_common.cuh"

namespace {

using gat::fold_group;
using gat::keep_scale;
using gat::kNeg;
using gat::kWarp;
using gat::leaky;
using gat::merge_row;
using gat::warp_sum;

constexpr int kMaxWarps = 8;
constexpr int kUnroll = 4;

// The logit of slot e, column j, in a row whose c is c_row: read from
// memory (flash-GAT) or formed from the rank-1 terms (kRank1).
template <bool kRank1>
__device__ __forceinline__ float logit_of(const float* __restrict__ logits,
                                          float c_row,
                                          const float* __restrict__ t,
                                          float slope, int e, int j) {
  return kRank1 ? leaky(c_row + __ldg(t + j), slope) : __ldg(logits + e);
}

// Dynamic shared memory: acc[n_warps][d] | m[n_warps] | s[n_warps]
template <bool kDrop, bool kRank1>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
flash_fwd_kernel(const int* __restrict__ ptr, const int* __restrict__ col,
                 const float* __restrict__ logits,
                 const float* __restrict__ c, const float* __restrict__ t,
                 float slope, const float* __restrict__ x,
                 const int* __restrict__ seed_ptr, float rate, float scale,
                 float* __restrict__ out, float* __restrict__ lse, int d) {
  extern __shared__ float smem[];
  const int n_warps = blockDim.x / kWarp;
  float* acc_all = smem;
  float* m_s = acc_all + n_warps * d;
  float* s_s = m_s + n_warps;
  const int row = blockIdx.x;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  float* acc = acc_all + warp * d;
  for (int f = lane; f < d; f += kWarp) acc[f] = 0.0f;

  const int begin = ptr[row];
  const int end = ptr[row + 1];
  const uint32_t seed = kDrop ? static_cast<uint32_t>(seed_ptr[0]) : 0u;
  const float c_row = kRank1 ? c[row] : 0.0f;
  float m = kNeg;
  float s = 0.0f;
  for (int e0 = begin + warp * kUnroll; e0 < end;
       e0 += n_warps * kUnroll) {
    int64_t xrow[kUnroll];
    float l[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u;
      const bool ok = e < end;
      const int j = ok ? __ldg(col + e) : 0;
      xrow[u] = ok ? static_cast<int64_t>(j) * d : -1;
      l[u] = ok ? logit_of<kRank1>(logits, c_row, t, slope, e, j) : kNeg;
    }
    fold_group<kUnroll, kDrop>(l, xrow, e0, seed, rate, scale, x, acc, d,
                               lane, m, s);
  }
  merge_row(m, s, acc_all, m_s, s_s, row, d, out, lse);
}

// Dynamic shared memory: g[d] | dc[n_warps].  One block per row (gridDim.x
// = n_rows); the same grid zeroes the pad slots [ptr[n_rows], n_out) of dl
// and q.  kRank1: dl holds dpre, q holds att, and dc[row] is written.
template <bool kDrop, bool kRank1>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
flash_bwd_kernel(const int* __restrict__ ptr, const int* __restrict__ col,
                 const float* __restrict__ logits,
                 const float* __restrict__ c, const float* __restrict__ t,
                 float slope, const float* __restrict__ x,
                 const float* __restrict__ gout,
                 const float* __restrict__ out, const float* __restrict__ lse,
                 const int* __restrict__ seed_ptr, float rate, float scale,
                 float* __restrict__ dl, float* __restrict__ q,
                 float* __restrict__ dc, int n_out, int d) {
  extern __shared__ float g_s[];
  float* dc_s = g_s + d;
  const int row = blockIdx.x;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int n_warps = blockDim.x / kWarp;
  const int64_t row_off = static_cast<int64_t>(row) * d;
  for (int f = threadIdx.x; f < d; f += blockDim.x) g_s[f] = gout[row_off + f];

  const int n_edges = ptr[gridDim.x];
  for (int64_t i = n_edges + static_cast<int64_t>(row) * blockDim.x +
                   threadIdx.x;
       i < n_out; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    dl[i] = 0.0f;
    q[i] = 0.0f;
  }
  __syncthreads();

  // <gout[r], out[r]>, by every warp (no extra barrier)
  float d_row = 0.0f;
  for (int f = lane; f < d; f += kWarp) {
    d_row = fmaf(g_s[f], out[row_off + f], d_row);
  }
  d_row = warp_sum(d_row);

  const int begin = ptr[row];
  const int end = ptr[row + 1];
  const float lse_row = lse[row];
  const bool live = lse_row > 0.5f * kNeg;
  const uint32_t seed = kDrop ? static_cast<uint32_t>(seed_ptr[0]) : 0u;
  const float c_row = kRank1 ? c[row] : 0.0f;
  float dc_lane = 0.0f;  // kRank1: this lane's edges' dpre
  for (int e0 = begin + warp * kUnroll; e0 < end;
       e0 += n_warps * kUnroll) {
    int64_t xrow[kUnroll];
    float l[kUnroll];
    float pre[kUnroll];
    float gx[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u;
      const bool ok = e < end;
      const int j = ok ? __ldg(col + e) : 0;
      xrow[u] = ok ? static_cast<int64_t>(j) * d : -1;
      // loaded with the column, so its latency hides behind the x loads
      pre[u] = kRank1 && ok ? c_row + __ldg(t + j) : 0.0f;
      l[u] = !ok ? 0.0f : kRank1 ? leaky(pre[u], slope) : __ldg(logits + e);
      gx[u] = 0.0f;
    }
    for (int f = lane; f < d; f += kWarp) {
      const float gf = g_s[f];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (xrow[u] >= 0) gx[u] = fmaf(__ldg(x + xrow[u] + f), gf, gx[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      gx[u] = warp_sum(gx[u]);
      const int e = e0 + u;
      if (lane == u && e < end) {
        const float att = live ? expf(l[u] - lse_row) : 0.0f;
        const float qe =
            kDrop ? att * keep_scale(static_cast<uint32_t>(e), seed, rate,
                                     scale)
                  : att;
        const float dle = qe * gx[u] - att * d_row;
        if (kRank1) {
          const float dpre = pre[u] >= 0.0f ? dle : slope * dle;
          dl[e] = dpre;
          dc_lane += dpre;
        } else {
          dl[e] = dle;
        }
        q[e] = qe;
      }
    }
  }
  if (kRank1) {
    const float dc_w = warp_sum(dc_lane);
    if (lane == 0) dc_s[warp] = dc_w;
    __syncthreads();
    if (threadIdx.x == 0) {
      float v = 0.0f;
      for (int k = 0; k < n_warps; ++k) v += dc_s[k];
      dc[row] = v;
    }
  }
}

size_t fwd_smem(int d, int n_warps) {
  return sizeof(float) * (static_cast<size_t>(d) * n_warps + 2 * n_warps);
}

size_t bwd_smem(int d, int n_warps) {
  return sizeof(float) * (static_cast<size_t>(d) + n_warps);
}

constexpr size_t kMaxSmem = 48 * 1024;

// d = 0 is a shape: the softmax statistics (lse, dl's second term, q) do
// not depend on the features.
bool bad_shape(int n_rows, int d, int n_warps) {
  return n_rows <= 0 || d < 0 || n_warps < 1 || n_warps > kMaxWarps;
}

}  // namespace

// All entry points launch on `stream`, do not synchronise, and return
// cudaGetLastError() after their launch (0 = launched).  `seed` is a device
// pointer to one int32, read only when rate > 0.  `scale` is the kept
// edges' factor 1/(1-rate), given by the caller in float32.

extern "C" int flash_fwd_f32(const int* ptr, const int* col,
                             const float* logits, const float* x,
                             const int* seed, float rate, float scale,
                             float* out, float* lse, int n_rows, int d,
                             int n_warps, cudaStream_t stream) {
  if (bad_shape(n_rows, d, n_warps) || fwd_smem(d, n_warps) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = fwd_smem(d, n_warps);
  if (rate > 0.0f) {
    flash_fwd_kernel<true, false><<<n_rows, n_warps * kWarp, smem, stream>>>(
        ptr, col, logits, nullptr, nullptr, 0.0f, x, seed, rate, scale, out,
        lse, d);
  } else {
    flash_fwd_kernel<false, false><<<n_rows, n_warps * kWarp, smem, stream>>>(
        ptr, col, logits, nullptr, nullptr, 0.0f, x, seed, rate, scale, out,
        lse, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// dl and q are [n_out] with n_out >= ptr[n_rows]; the pads get 0.
extern "C" int flash_bwd_f32(const int* ptr, const int* col,
                             const float* logits, const float* x,
                             const float* gout, const float* out,
                             const float* lse, const int* seed, float rate,
                             float scale, float* dl, float* q, int n_rows,
                             int n_out, int d, int n_warps,
                             cudaStream_t stream) {
  if (bad_shape(n_rows, d, n_warps) || n_out < 0 ||
      bwd_smem(d, n_warps) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = bwd_smem(d, n_warps);
  if (rate > 0.0f) {
    flash_bwd_kernel<true, false><<<n_rows, n_warps * kWarp, smem, stream>>>(
        ptr, col, logits, nullptr, nullptr, 0.0f, x, gout, out, lse, seed,
        rate, scale, dl, q, nullptr, n_out, d);
  } else {
    flash_bwd_kernel<false, false><<<n_rows, n_warps * kWarp, smem, stream>>>(
        ptr, col, logits, nullptr, nullptr, 0.0f, x, gout, out, lse, seed,
        rate, scale, dl, q, nullptr, n_out, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// The generic rank-1 GAT forward: out [n_rows, d] and lse [n_rows] of the
// logits leaky(c[r] + t[col_e]); c [n_rows], t [n_cols], x [n_cols, d].
extern "C" int r1_fwd_f32(const int* ptr, const int* col, const float* c,
                          const float* t, const float* x, float slope,
                          float* out, float* lse, int n_rows, int d,
                          int n_warps, cudaStream_t stream) {
  if (bad_shape(n_rows, d, n_warps) || fwd_smem(d, n_warps) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  flash_fwd_kernel<false, true>
      <<<n_rows, n_warps * kWarp, fwd_smem(d, n_warps), stream>>>(
          ptr, col, nullptr, c, t, slope, x, nullptr, 0.0f, 1.0f, out, lse,
          d);
  return static_cast<int>(cudaGetLastError());
}

// Its recompute backward: att and dpre [n_out] (n_out >= ptr[n_rows], the
// pads 0) and dc [n_rows]; gout, out [n_rows, d] and lse [n_rows] as the
// forward gave them.
extern "C" int r1_bwd_f32(const int* ptr, const int* col, const float* c,
                          const float* t, const float* x, const float* gout,
                          const float* out, const float* lse, float slope,
                          float* att, float* dpre, float* dc, int n_rows,
                          int n_out, int d, int n_warps,
                          cudaStream_t stream) {
  if (bad_shape(n_rows, d, n_warps) || n_out < 0 ||
      bwd_smem(d, n_warps) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  flash_bwd_kernel<false, true>
      <<<n_rows, n_warps * kWarp, bwd_smem(d, n_warps), stream>>>(
          ptr, col, nullptr, c, t, slope, x, gout, out, lse, nullptr, 0.0f,
          1.0f, dpre, att, dc, n_out, d);
  return static_cast<int>(cudaGetLastError());
}

// The largest warps per block (1..8) whose shared memory fits both kernels
// (in either form) at feature width d; 0 when even one warp does not fit.
extern "C" int flash_max_warps(int d) {
  for (int w = kMaxWarps; w >= 1; --w) {
    if (fwd_smem(d, w) <= kMaxSmem && bwd_smem(d, w) <= kMaxSmem) return w;
  }
  return 0;
}

extern "C" const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
