// Flash-GAT in float32: the softmax of given per-edge logits over each CSR
// row, the hashed attention dropout and the aggregation in one pass
// (flash_fwd_f32), and its recompute backward (flash_bwd_f32); and the
// generic rank-1 GAT's backward (r1_bwd_f32; its forward, r1_fwd_f32, is
// in rank1_gat.cu).
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
// Generic rank-1 GAT backward (no dropout): the logits are
//
//   pre_e = c[r] + t[j],   l_e = leaky(pre_e, slope)
//
// with c [n_rows] per row and t [n_cols] per column, read per edge.  It
// writes att_e (as q) and dpre_e = dl_e * (pre_e >= 0 ? 1 : slope) (in
// dl's place), and dc[r] = sum_{e in r} dpre_e, summed in the row's block
// in a fixed order; the caller takes dx = the att-weighted transposed
// csr_spmm_f32 of gout and dt[j] = sum_{e: col_e = j} dpre_e.
//
// Replaces three TPU kernels:
//   * msha_gnn_tpu/ops/pallas/flash_gat.py:51 _flash_kernel, the forward
//     above;
//   * flash_gat.py:167 _flash_bwd_kernel, which writes dl and
//     z_e = q_e gout[r_e] ([E, d], reduced by column for dx afterwards).
//     Only the operator's function (dl, dx) is kept: z is not written;
//   * msha_gnn_tpu/ops/pallas/rank1_gat.py:160 _r1_bwd_kernel, which writes
//     [z || dpre] ([E, d+1]) for one transpose reduce of dx and dt, and dc.
//     Here 2 floats an edge (att, dpre), not d + 1: dx and dt are two
//     reduces that read them.
// The TPU kernels walk 128-row visit blocks with one-hot MXU scatters and
// a bf16 hi/lo split; none of that carries over.  Here the work is plain
// f32.
//
// Bound, at the linkpred shapes (n 4,267, E 328,012, d 64): bytes.
// Forward 4.8 MB (col, logits, x once, out, ptr, lse) against 2 E d flops;
// backward 8.6 MB (adds gout, out and the dl, q writes).  The rank-1
// backward reads c and t (per node) in place of the E logits.
//
// flash_fwd_f32: the edge-run walk of gat_fwd.cuh with the logit source
// kRead (logits[e], one load beside the edge's row of x): a warp per run
// of `run` consecutive CSR slots, split into groups of G lanes, one edge a
// group, each group an online softmax (m, s, acc) in registers, the
// groups merged in a fixed order, and a second grid that merges the rows
// crossing runs in run order.  A wide d takes tiles on blockIdx.y; the
// logits are read, so the tiles agree on the softmax trivially.
//
// flash_bwd_f32 has no output that sums over a row, so it runs on the
// edge-run schedule of runs.cuh in one grid: a warp per run of `run`
// consecutive CSR slots (a long row spread over as many warps as it has
// runs), split into groups of G lanes (8, 16 or 32), one edge a group
// (gat_runs.cuh).  For each row piece the warp holds gout[r] in registers
// (d / G floats a lane) and forms <gout[r], out[r]> and lse[r] once; a
// group's dot <gout[r], x[j]> is a float4-wide multiply-add a lane and a
// log2(G)-round shuffle sum, and one lane of the group does the edge's
// scalar work and its two stores.  The same grid zeroes the pads.
//
// r1_bwd_f32 (simple and right first): one block per row.  The block holds
// gout[r] in shared memory, each warp forms <gout[r], out[r]> once and
// takes every n_warps-th group of kUnroll edges, one d-wide dot per edge
// (lanes over 32-wide feature tiles, so any d works); dc is a lane, warp,
// then warp-order sum.
//
// No float atomics, so results are deterministic.

#include <cuda_runtime.h>

#include <cstdint>

#include "gat_common.cuh"
#include "gat_fwd.cuh"
#include "gat_runs.cuh"
#include "runs.cuh"

namespace {

using gat::keep_scale;
using gat::kNeg;
using gat::kWarp;
using gat::leaky;
using gat::warp_sum;

constexpr int kMaxWarps = 8;
constexpr int kUnroll = 4;

// flash_bwd_f32: one warp per run of `run` slots of [0, n_slots), groups
// of kG lanes one edge each (gat_runs.cuh).  For each row piece it enters,
// the warp holds gout[r] in registers (its lanes' features of it) and forms
// lse[r] and <gout[r], out[r]> once; then each group takes every
// (32 / kG)-th edge of the piece: one kG-lane dot <gout[r], x[j]>, then one
// lane of the group the edge's scalars and its two stores.  The same grid
// zeroes the pad slots [ptr[n_rows], n_slots) of dl and q.  Nothing sums
// over a row, so there is no second grid.
template <int kG, int kPer, bool kDrop>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
flash_bwd_kernel(const int* __restrict__ ptr, const int* __restrict__ col,
                 const float* __restrict__ logits,
                 const float* __restrict__ x, const float* __restrict__ gout,
                 const float* __restrict__ out, const float* __restrict__ lse,
                 const int* __restrict__ seed_ptr, float rate, float scale,
                 float* __restrict__ dl, float* __restrict__ q, int n_rows,
                 int n_slots, int64_t n_runs, int run, int d) {
  using L = gat_runs::Layout<kG, kPer>;
  constexpr int kGroups = kWarp / kG;
  constexpr int kSteps = L::kSteps;
  const int n_warps = blockDim.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int li = lane % kG;
  const int grp = lane / kG;
  const int64_t k =
      static_cast<int64_t>(blockIdx.x) * n_warps + threadIdx.x / kWarp;
  if (k >= n_runs) return;
  const int n_edges = __ldg(ptr + n_rows);
  // the pads in the run's slots
  const int64_t slot_end =
      (k + 1) * run < n_slots ? (k + 1) * run : static_cast<int64_t>(n_slots);
  for (int64_t e = (k * run > n_edges ? k * run : n_edges) + lane;
       e < slot_end; e += kWarp) {
    dl[e] = 0.0f;
    q[e] = 0.0f;
  }
  int first = 0;
  int last = 0;
  if (!runs::bounds(k, run, n_edges, first, last)) return;
  const uint32_t seed = kDrop ? static_cast<uint32_t>(__ldg(seed_ptr)) : 0u;
  int row = runs::warp_row_of(ptr, n_rows, first, lane);
  int rb = __ldg(ptr + row);
  int re = __ldg(ptr + row + 1);
  while (true) {
    const int64_t off = static_cast<int64_t>(row) * d;
    float gv[kPer];
    float ov[kPer];
    gat_runs::load_lane<kG, kPer>(gout + off, 0, d, li, gv);
    gat_runs::load_lane<kG, kPer>(out + off, 0, d, li, ov);
    const float d_row = gat_runs::group_sum<kG>(gat_runs::lane_dot<kG, kPer>(
        gv, ov, gout + off, out + off, 0, d, li));
    const float lse_row = __ldg(lse + row);
    const bool live = lse_row > 0.5f * kNeg;
    const int pe = min(re, last);
    for (int eb = max(rb, first); eb < pe; eb += kGroups * kSteps) {
      bool ok[kSteps];
      int64_t xrow[kSteps];
      float l[kSteps];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int e = eb + u * kGroups + grp;
        ok[u] = e < pe;
        xrow[u] = ok[u] ? static_cast<int64_t>(__ldg(col + e)) * d : 0;
        l[u] = ok[u] ? __ldg(logits + e) : 0.0f;
      }
      float xv[kSteps][kPer];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        if (ok[u]) {
          gat_runs::load_lane<kG, kPer>(x + xrow[u], 0, d, li, xv[u]);
        } else {
#pragma unroll
          for (int i = 0; i < kPer; ++i) xv[u][i] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const float gx = gat_runs::group_sum<kG>(
            ok[u] ? gat_runs::lane_dot<kG, kPer>(xv[u], gv, x + xrow[u],
                                                  gout + off, 0, d, li)
                  : 0.0f);
        if (ok[u] && li == u % kG) {
          const int e = eb + u * kGroups + grp;
          const float att = live ? expf(l[u] - lse_row) : 0.0f;
          const float qe =
              kDrop ? att * keep_scale(static_cast<uint32_t>(e), seed, rate,
                                       scale)
                    : att;
          dl[e] = qe * gx - att * d_row;
          q[e] = qe;
        }
      }
    }
    if (re >= last) break;  // the piece reached the run's end
    ++row;                  // the next row with an edge
    rb = re;
    re = __ldg(ptr + row + 1);
    while (re == rb) {
      ++row;
      re = __ldg(ptr + row + 1);
    }
  }
}

// r1_bwd_f32: one block per row (gridDim.x = n_rows); the same grid zeroes
// the pad slots [ptr[n_rows], n_out) of att and dpre.  Dynamic shared
// memory: g[d] | dc[n_warps].
__global__ void __launch_bounds__(kMaxWarps * kWarp)
r1_bwd_kernel(const int* __restrict__ ptr, const int* __restrict__ col,
              const float* __restrict__ c, const float* __restrict__ t,
              float slope, const float* __restrict__ x,
              const float* __restrict__ gout, const float* __restrict__ out,
              const float* __restrict__ lse, float* __restrict__ dpre,
              float* __restrict__ att, float* __restrict__ dc, int n_out,
              int d) {
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
    dpre[i] = 0.0f;
    att[i] = 0.0f;
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
  const float c_row = c[row];
  float dc_lane = 0.0f;  // this lane's edges' dpre
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
      pre[u] = ok ? c_row + __ldg(t + j) : 0.0f;
      l[u] = ok ? leaky(pre[u], slope) : 0.0f;
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
        const float a_e = live ? expf(l[u] - lse_row) : 0.0f;
        const float dle = a_e * gx[u] - a_e * d_row;
        const float dp = pre[u] >= 0.0f ? dle : slope * dle;
        dpre[e] = dp;
        dc_lane += dp;
        att[e] = a_e;
      }
    }
  }
  const float dc_w = warp_sum(dc_lane);
  if (lane == 0) dc_s[warp] = dc_w;
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = 0.0f;
    for (int k = 0; k < n_warps; ++k) v += dc_s[k];
    dc[row] = v;
  }
}

size_t bwd_smem(int d, int n_warps) {
  return sizeof(float) * (static_cast<size_t>(d) + n_warps);
}

constexpr size_t kMaxSmem = 48 * 1024;

using BwdKernel = void (*)(const int*, const int*, const float*, const float*,
                           const float*, const float*, const float*,
                           const int*, float, float, float*, float*, int, int,
                           int64_t, int, int);

template <int kG, bool kDrop>
BwdKernel bwd_kernel_per(int per) {
  switch (per) {
    case 1:
      return flash_bwd_kernel<kG, 1, kDrop>;
    case 2:
      return flash_bwd_kernel<kG, 2, kDrop>;
    case 4:
      return flash_bwd_kernel<kG, 4, kDrop>;
    default:
      return flash_bwd_kernel<kG, 8, kDrop>;
  }
}

template <bool kDrop>
BwdKernel bwd_kernel(int group, int per) {
  switch (group) {
    case 8:
      return bwd_kernel_per<8, kDrop>(per);
    case 16:
      return bwd_kernel_per<16, kDrop>(per);
    default:
      return bwd_kernel_per<32, kDrop>(per);
  }
}

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

// Two grids (gat_fwd.cuh): the runs (rows inside a run, head and tail
// pieces of the others), then the crossing rows' pieces merged in run
// order.  col [n_slots] in CSR order, n_slots >= ptr[n_rows] (the edge
// count is read from ptr on the card); logits [>= ptr[n_rows]], x [n_cols,
// d]; out [n_rows, d], lse [n_rows]; ws [n_runs (2 d + 5)] float32 with
// n_runs = max(1, ceil(n_slots / run)); group the lanes an edge, 8, 16 or
// 32.
extern "C" int flash_fwd_f32(const int* ptr, const int* col,
                             const float* logits, const float* x,
                             const int* seed, float rate, float scale,
                             float* out, float* lse, float* ws, int n_rows,
                             int n_slots, int run, int group, int d,
                             int n_warps, cudaStream_t stream) {
  const gat_fwd::LogitArgs args{logits, nullptr, nullptr, nullptr, 0.0f};
  return gat_fwd::launch<gat_fwd::Logit::kRead>(
      ptr, col, args, x, seed, rate, scale, out, lse, ws, n_rows, n_slots,
      run, group, d, n_warps, stream);
}

// dl and q are [n_out] with n_out >= ptr[n_rows] (the edge count is read
// from ptr on the card); the pads get 0.  One grid of warps over runs of
// `run` slots of [0, n_out); group the lanes an edge, 8, 16 or 32.
extern "C" int flash_bwd_f32(const int* ptr, const int* col,
                             const float* logits, const float* x,
                             const float* gout, const float* out,
                             const float* lse, const int* seed, float rate,
                             float scale, float* dl, float* q, int n_rows,
                             int n_out, int run, int group, int d,
                             int n_warps, cudaStream_t stream) {
  if (bad_shape(n_rows, d, n_warps) || n_out < 0 || run < 1 ||
      !(group == 8 || group == 16 || group == 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_runs = runs::count(n_out, run);
  const uintptr_t at = reinterpret_cast<uintptr_t>(x) |
                       reinterpret_cast<uintptr_t>(gout) |
                       reinterpret_cast<uintptr_t>(out);
  const int per = gat_runs::per_lane(group, d, at);
  const BwdKernel kernel = rate > 0.0f ? bwd_kernel<true>(group, per)
                                       : bwd_kernel<false>(group, per);
  kernel<<<static_cast<unsigned>((n_runs + n_warps - 1) / n_warps),
           n_warps * kWarp, 0, stream>>>(ptr, col, logits, x, gout, out, lse,
                                         seed, rate, scale, dl, q, n_rows,
                                         n_out, n_runs, run, d);
  return static_cast<int>(cudaGetLastError());
}

// The generic rank-1 GAT backward: att and dpre [n_out] (n_out >=
// ptr[n_rows], the pads 0) and dc [n_rows]; gout, out [n_rows, d] and lse
// [n_rows] as r1_fwd_f32 gave them.
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
  r1_bwd_kernel<<<n_rows, n_warps * kWarp, bwd_smem(d, n_warps), stream>>>(
      ptr, col, c, t, slope, x, gout, out, lse, dpre, att, dc, n_out, d);
  return static_cast<int>(cudaGetLastError());
}

// The largest warps per block (1..8) whose shared memory fits r1_bwd_f32,
// the one kernel here that keeps any, at feature width d; 0 when even one
// warp does not fit.
extern "C" int flash_max_warps(int d) {
  for (int w = kMaxWarps; w >= 1; --w) {
    if (bwd_smem(d, w) <= kMaxSmem) return w;
  }
  return 0;
}

extern "C" const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
