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
//       dc[r] = sum_{e in r} dpre_e,   da = sum_all e dpre_e x[j],
//     and dx[j] = sum_{e: col = j} z_e for z_e = q_e gout[r] + dpre_e a.
//     The TPU kernel writes z [E, d] for an XLA reduce; this one writes q
//     and dpre (2 floats an edge, CSR order) and the caller forms dx as
//     the q-weighted transposed csr_spmm_f32 of gout plus a times the
//     column sums of dpre (a d = 1 csr_spmm_f32): the same sum, without
//     the E x d round trip (84 MB each way at the linkpred shapes).
// The TPU kernels walk 128-row blocks with one-hot MXU reduces and a bf16
// hi/lo split; none of that carries over.  Here the work is plain f32.
//
// The keep mask is a pure function of (seed, slot) with slot = e, the
// edge's index in the padded CSR array: gat::keep_scale of gat_common.cuh,
// the murmur3 finalizer of _hash01 (rank1_gat.py:66-82) in uint32
// arithmetic, bit for bit.  Forward and backward hash the same slots, so
// they see the same mask and no mask is stored.
//
// Bound: bytes at the linkpred shapes.  Forward: the CSR arrays, c, x and
// out (a few MB, x staying in L2) against 4 E d flops; its workspace of
// crossing-row pieces (about 1.4 MB at d 64) is the schedule's, not the
// function's.  Backward: the CSR arrays, c, x, gout, out and lse in, q
// and dpre (8 B an edge), dc and da out, about 6 MB; 7 E d flops, a few us
// at the float32 rate.
//
// Forward: on the edge-run schedule of runs.cuh, a warp per run of `run`
// consecutive CSR slots, so a long row is spread over as many warps as it
// has runs.  The warp is split into groups of G lanes (8, 16 or 32), one
// edge a group (gat_runs.cuh): a lane holds d / G of the features of x[j]
// in registers (a float4 at d 64, G 16), the dot <x[j], a> is a
// log2(G)-round shuffle sum within the group, and each group keeps its own
// online softmax (m, s, acc) of the row piece in registers, taking every
// (32 / G)-th edge of it.  At the end of a row piece the groups merge in a
// fixed order by shuffles; a row that lies inside the run is written, a
// row that crosses the run's ends leaves its piece (m, s, acc[d]) in the
// run's head or tail partial, and a second grid of the same entry point
// merges those in run order (runs.cuh says which run writes what, and who
// zeroes the empty rows).  A width d that one group's registers do not
// cover takes several tiles of features (blockIdx.y), each forming the
// full logits in the same order.
//
// Backward: edge-parallel on the edge-run schedule of runs.cuh, so a long
// row is spread over as many warps as it has runs.  Apart from dc[r] and
// da, each edge needs only its row's scalars (c[r], lse[r], <gout[r],
// out[r]>, taken once per row piece by the warp) and gout[r].  A warp walks
// its run in batches of 32 edges, whose columns it loads in one coalesced
// load and hands out by shuffles, and in groups of kEdges edges (lanes
// over features, the group's rows of x in flight together, two warp sums
// an edge); dc is summed by
// row piece as csr_spmm_f32 sums a d = 1 row, its crossing rows added up
// in run order; da is summed in the warp's row of shared memory and
// written as the run's partial [n_runs, d].  A second grid of the same
// entry point adds the da partials in a fixed order (full f32, as the TPU
// kernel keeps it on purpose, rank1_gat.py:384-388) and the crossing rows'
// dc pieces.  No float atomics anywhere, so results are deterministic.

#include <cuda_runtime.h>

#include <cstdint>

#include "gat_common.cuh"
#include "gat_runs.cuh"
#include "runs.cuh"

namespace {

using gat::keep_scale;
using gat::kNeg;
using gat::kWarp;
using gat::leaky;
using gat::warp_sum;

constexpr int kMaxWarps = 8;
constexpr int kEdges = 4;   // r1l_bwd_f32: edges whose rows are in flight

// Where r1l_fwd_f32's workspace keeps the pieces of the rows that cross
// runs: [n_runs, d] of acc for the head and the tail pieces, then m and s
// of each, then cross (int32), all [n_runs].
struct FwdWs {
  float* head_acc;
  float* tail_acc;
  float* head_m;
  float* head_s;
  float* tail_m;
  float* tail_s;
  int* cross;
};

FwdWs fwd_ws(float* ws, int64_t n_runs, int d) {
  float* scalars = ws + 2 * n_runs * d;
  return {ws,
          ws + n_runs * d,
          scalars,
          scalars + n_runs,
          scalars + 2 * n_runs,
          scalars + 3 * n_runs,
          reinterpret_cast<int*>(scalars + 4 * n_runs)};
}

// One warp per run of `run` CSR slots, groups of kG lanes one edge each
// (gat_runs.cuh), blockIdx.y the tile of kG kPer features this block
// aggregates; every tile forms the full logits, in the same order, so all
// tiles see the same softmax.  A row piece's state is the groups' pieces
// merged in a fixed order; a row inside the run is written, a crossing row
// leaves its piece in the run's head or tail partial for the fix-up grid.
template <int kG, int kPer, bool kDrop>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
r1l_fwd_kernel(const int* __restrict__ ptr, const int* __restrict__ col,
               const float* __restrict__ c, const float* __restrict__ a,
               const float* __restrict__ x, const int* __restrict__ seed_ptr,
               float rate, float scale, float slope, float* __restrict__ out,
               float* __restrict__ lse, FwdWs ws, int n_rows,
               int64_t n_runs, int run, int d) {
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
  const int base = blockIdx.y * L::kTile;
  const bool lead = blockIdx.y == 0;  // writes lse, m, s and cross
  const int tile_end = min(d, base + L::kTile);
  // an empty row: this tile of out, and lse
  auto zero_row = [&](int r) {
    for (int f = base + lane; f < tile_end; f += kWarp) {
      out[static_cast<int64_t>(r) * d + f] = 0.0f;
    }
    if (lead && lane == 0) lse[r] = kNeg;
  };

  const int n_edges = __ldg(ptr + n_rows);
  int first = 0;
  int last = 0;
  if (!runs::bounds(k, run, n_edges, first, last)) {  // past the last edge
    if (k == 0) {  // no edges at all
      for (int r = 0; r < n_rows; ++r) zero_row(r);
    }
    return;
  }
  const int r0 = runs::warp_row_of(ptr, n_rows, first, lane);
  for (int r = runs::first_owned(ptr, r0, first); r < r0; ++r) zero_row(r);
  float av[kPer];
  gat_runs::load_lane<kG, kPer>(a, base, d, li, av);
  const uint32_t seed = kDrop ? static_cast<uint32_t>(__ldg(seed_ptr)) : 0u;
  int row = r0;
  int rb = __ldg(ptr + row);
  int re = __ldg(ptr + row + 1);
  while (true) {
    // the piece [pb, pe) of the row: group grp takes every kGroups-th edge
    const int pb = max(rb, first);
    const int pe = min(re, last);
    const float c_row = __ldg(c + row);
    gat_runs::Piece<kPer> st;
    st.reset();
    // a step's columns are loaded a step ahead, so their latency hides
    // behind the step before
    int j_next[kSteps];
    gat_runs::load_step<kSteps, kGroups>(col, pb, pe, grp, j_next);
    for (int eb = pb; eb < pe; eb += kGroups * kSteps) {
      bool ok[kSteps];
      int64_t xrow[kSteps];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        ok[u] = eb + u * kGroups + grp < pe;
        xrow[u] = static_cast<int64_t>(j_next[u]) * d;
      }
      gat_runs::load_step<kSteps, kGroups>(col, eb + kGroups * kSteps, pe,
                                           grp, j_next);
      float xv[kSteps][kPer];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        if (ok[u]) {
          gat_runs::load_lane<kG, kPer>(x + xrow[u], base, d, li, xv[u]);
        } else {
#pragma unroll
          for (int i = 0; i < kPer; ++i) xv[u][i] = 0.0f;
        }
      }
      float l[kSteps];
      float keep[kSteps];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const float t = gat_runs::group_sum<kG>(
            ok[u] ? gat_runs::lane_dot<kG, kPer>(xv[u], av, x + xrow[u], a,
                                                  base, d, li)
                  : 0.0f);
        l[u] = leaky(c_row + t, slope);
        keep[u] = kDrop ? keep_scale(static_cast<uint32_t>(
                                         eb + u * kGroups + grp),
                                     seed, rate, scale)
                        : 1.0f;
      }
      gat_runs::fold<kSteps, kPer>(st, l, keep, ok, xv);
    }
    gat_runs::merge_groups<kG, kPer>(st);
    const runs::Target to = runs::target(rb, re, first, last);
    if (grp == 0) {
      if (to == runs::kOut) {
        float v[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          v[i] = st.s > 0.0f ? st.acc[i] / st.s : 0.0f;
        }
        gat_runs::store_lane<kG, kPer>(out + static_cast<int64_t>(row) * d,
                                       base, d, li, v);
        if (lead && li == 0) {
          lse[row] = st.s > 0.0f ? st.m + logf(st.s) : kNeg;
        }
      } else {
        const bool head = to == runs::kHead;
        gat_runs::store_lane<kG, kPer>(
            (head ? ws.head_acc : ws.tail_acc) + k * d, base, d, li, st.acc);
        if (lead && li == 0) {
          (head ? ws.head_m : ws.tail_m)[k] = st.m;
          (head ? ws.head_s : ws.tail_s)[k] = st.s;
        }
      }
    }
    if (re >= last) break;  // the piece reached the run's end
    // the next row with an edge; the empty ones before it begin in the run
    ++row;
    rb = re;
    re = __ldg(ptr + row + 1);
    while (re == rb) {
      zero_row(row);
      ++row;
      re = __ldg(ptr + row + 1);
    }
  }
  if (lead && lane == 0) {
    ws.cross[k] = runs::target(rb, re, first, last) == runs::kTail ? row : -1;
  }
  if (last == n_edges) {  // the empty rows after the last edge
    for (int r = row + 1; r < n_rows; ++r) zero_row(r);
  }
}

// r1l_fwd_f32's second grid: a warp per run k, which merges the row r that
// begins in it and ends after it (cross[k]) in run order, tail[k] (+)
// head[k + 1] (+) ... (+) head[k_end], and writes out[r] = acc / s and
// lse[r] = m + log s.  A lane merges kFixFeatures features at once (lanes
// over features, 128 a pass: one pass at d <= 128), and the chain's loop
// is unrolled so that the loads of several pieces are in flight together:
// a long row's chain (30 pieces for the 3,842-edge row at 128 slots a
// run) is not walked at one memory latency a piece.
constexpr int kFixFeatures = 4;

__global__ void __launch_bounds__(kMaxWarps * kWarp)
r1l_fwd_fixup_kernel(const int* __restrict__ ptr, FwdWs ws,
                     float* __restrict__ out, float* __restrict__ lse,
                     int n_rows, int64_t n_runs, int run, int d) {
  const int lane = threadIdx.x % kWarp;
  const int64_t k = static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp) +
                    threadIdx.x / kWarp;
  if (k >= n_runs) return;
  int64_t k_end = 0;
  const int r = runs::crossing_row(ptr, ws.cross, __ldg(ptr + n_rows), run, k,
                                   k_end);
  if (r < 0) return;
  for (int f0 = 0; f0 == 0 || f0 < d; f0 += kWarp * kFixFeatures) {
    float m = __ldg(ws.tail_m + k);
    float s = __ldg(ws.tail_s + k);
    float acc[kFixFeatures];
#pragma unroll
    for (int i = 0; i < kFixFeatures; ++i) {
      const int f = f0 + i * kWarp + lane;
      acc[i] = f < d ? __ldg(ws.tail_acc + k * d + f) : 0.0f;
    }
#pragma unroll 4
    for (int64_t j = k + 1; j <= k_end; ++j) {
      float r1;
      float r2;
      gat_runs::merge(m, s, __ldg(ws.head_m + j), __ldg(ws.head_s + j), r1,
                      r2);
#pragma unroll
      for (int i = 0; i < kFixFeatures; ++i) {
        const int f = f0 + i * kWarp + lane;
        if (f < d) acc[i] = fmaf(__ldg(ws.head_acc + j * d + f), r2,
                                 acc[i] * r1);
      }
    }
#pragma unroll
    for (int i = 0; i < kFixFeatures; ++i) {
      const int f = f0 + i * kWarp + lane;
      if (f < d) {
        out[static_cast<int64_t>(r) * d + f] = s > 0.0f ? acc[i] / s : 0.0f;
      }
    }
    if (f0 == 0 && lane == 0) lse[r] = s > 0.0f ? m + logf(s) : kNeg;
  }
}

// The scalars of one row that every edge of it needs.
struct RowState {
  int row;
  int begin;
  int end;
  float c;
  float lse;
  float dot;  // <gout[row], out[row]>
  bool live;
};

// Moves `st` to row `row`; every lane of the warp calls it.
__device__ __forceinline__ void enter_row(RowState& st, int row,
                                          const int* __restrict__ ptr,
                                          const float* __restrict__ c,
                                          const float* __restrict__ gout,
                                          const float* __restrict__ out,
                                          const float* __restrict__ lse,
                                          int d, int lane) {
  st.row = row;
  st.begin = __ldg(ptr + row);
  st.end = __ldg(ptr + row + 1);
  st.c = __ldg(c + row);
  st.lse = __ldg(lse + row);
  st.live = st.lse > 0.5f * kNeg;
  const int64_t off = static_cast<int64_t>(row) * d;
  float v = 0.0f;
  for (int f = lane; f < d; f += kWarp) {
    v = fmaf(__ldg(gout + off + f), __ldg(out + off + f), v);
  }
  st.dot = warp_sum(v);
}

// Dynamic shared memory: a[d] | da[n_warps][d].  One warp per run of `run`
// CSR slots of [0, n_slots); the edges are the slots [0, ptr[n_rows]), read
// on the card, and q and dpre are 0 on the slots past them.  ws: dc_head
// [n_runs] | dc_tail [n_runs] | cross [n_runs] (int32) | da_part [n_runs, d].
// Lanes hold kVec consecutive features of each 32 kVec-wide tile.
template <int kVec, bool kDrop>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
r1l_bwd_kernel(const int* __restrict__ ptr, const int* __restrict__ col,
               const float* __restrict__ c, const float* __restrict__ a,
               const float* __restrict__ x, const float* __restrict__ gout,
               const float* __restrict__ out, const float* __restrict__ lse,
               const int* __restrict__ seed_ptr, float rate, float scale,
               float slope, float* __restrict__ q, float* __restrict__ dpre,
               float* __restrict__ dc, float* __restrict__ dc_head,
               float* __restrict__ dc_tail, int* __restrict__ cross,
               float* __restrict__ da_part, int n_rows, int n_slots,
               int64_t n_runs, int run, int d) {
  extern __shared__ float smem[];
  const int n_warps = blockDim.x / kWarp;
  float* a_s = smem;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  float* da_acc = a_s + d + warp * d;
  for (int f = threadIdx.x; f < d; f += blockDim.x) a_s[f] = a[f];
  for (int f = lane; f < d; f += kWarp) da_acc[f] = 0.0f;
  __syncthreads();

  const int64_t k = static_cast<int64_t>(blockIdx.x) * n_warps + warp;
  if (k >= n_runs) return;
  float* da_row = da_part + k * d;
  const int n_edges = __ldg(ptr + n_rows);
  // the pads in the run's slots
  const int64_t slot_end =
      (k + 1) * run < n_slots ? (k + 1) * run : static_cast<int64_t>(n_slots);
  for (int64_t e = (k * run > n_edges ? k * run : n_edges) + lane;
       e < slot_end; e += kWarp) {
    q[e] = 0.0f;
    dpre[e] = 0.0f;
  }
  int first = 0;
  int last = 0;
  if (!runs::bounds(k, run, n_edges, first, last)) {  // past the last edge
    if (k == 0) {  // no edges at all
      for (int r = lane; r < n_rows; r += kWarp) dc[r] = 0.0f;
    }
    for (int f = lane; f < d; f += kWarp) da_row[f] = 0.0f;
    return;
  }
  const int r0 = runs::warp_row_of(ptr, n_rows, first, lane);
  if (lane == 0) {
    for (int r = runs::first_owned(ptr, r0, first); r < r0; ++r) dc[r] = 0.0f;
  }
  const uint32_t seed = kDrop ? static_cast<uint32_t>(seed_ptr[0]) : 0u;
  RowState st;
  enter_row(st, r0, ptr, c, gout, out, lse, d, lane);
  // dc's own walk: the row whose piece dc_acc holds
  int dc_row = r0;
  int dc_begin = st.begin;
  int dc_end = st.end;
  float dc_acc = 0.0f;
  for (int b = first; b < last; b += kWarp) {
    // the batch's columns in one coalesced load, handed out by shuffles
    const int n_b = min(kWarp, last - b);
    const int my_col = lane < n_b ? __ldg(col + b + lane) : 0;
    for (int g = 0; g < n_b; g += kEdges) {
      const int e0 = b + g;
      int64_t xrow[kEdges];
      int grow[kEdges];
      float cu[kEdges];
      float lu[kEdges];
      float du[kEdges];
      bool live[kEdges];
#pragma unroll
      for (int u = 0; u < kEdges; ++u) {
        const int e = e0 + u;
        xrow[u] = -1;
        const int j = __shfl_sync(gat::kFull, my_col, g + u);
        if (g + u < n_b) {
          int row = st.row;
          while (e >= st.end) ++row, st.end = __ldg(ptr + row + 1);
          if (row != st.row) {
            enter_row(st, row, ptr, c, gout, out, lse, d, lane);
          }
          xrow[u] = static_cast<int64_t>(j) * d;
        }
        grow[u] = st.row;
        cu[u] = st.c;
        lu[u] = st.lse;
        du[u] = st.dot;
        live[u] = st.live;
      }
      float t[kEdges];
      float gx[kEdges];
#pragma unroll
      for (int u = 0; u < kEdges; ++u) t[u] = gx[u] = 0.0f;
      for (int f = lane * kVec; f < d; f += kWarp * kVec) {
        float av[kVec];
        runs::load_vec<kVec>(a_s + f, av);
#pragma unroll
        for (int u = 0; u < kEdges; ++u) {
          if (xrow[u] >= 0) {
            float xv[kVec];
            float gv[kVec];
            runs::ldg_vec<kVec>(x + xrow[u] + f, xv);
            runs::ldg_vec<kVec>(
                gout + static_cast<int64_t>(grow[u]) * d + f, gv);
#pragma unroll
            for (int i = 0; i < kVec; ++i) {
              t[u] = fmaf(xv[i], av[i], t[u]);
              gx[u] = fmaf(xv[i], gv[i], gx[u]);
            }
          }
        }
      }
      float qv[kEdges];
      float dp[kEdges];
#pragma unroll
      for (int u = 0; u < kEdges; ++u) {
        t[u] = warp_sum(t[u]);
        gx[u] = warp_sum(gx[u]);
        const float pre = cu[u] + t[u];
        const bool ok = xrow[u] >= 0 && live[u];
        const float att = ok ? expf(leaky(pre, slope) - lu[u]) : 0.0f;
        qv[u] = kDrop ? att * keep_scale(static_cast<uint32_t>(e0 + u), seed,
                                         rate, scale)
                      : att;
        const float dl = qv[u] * gx[u] - att * du[u];
        dp[u] = xrow[u] >= 0 ? dl * (pre >= 0.0f ? 1.0f : slope) : 0.0f;
        if (lane == u && xrow[u] >= 0) {
          q[e0 + u] = qv[u];
          dpre[e0 + u] = dp[u];
        }
      }
#pragma unroll
      for (int u = 0; u < kEdges; ++u) {
        const int e = e0 + u;
        if (g + u < n_b) {
          while (e >= dc_end) {  // dc_row ends inside the run
            if (lane == 0) {
              float* dst = dc + dc_row;
              if (runs::target(dc_begin, dc_end, first, last) == runs::kHead) {
                dst = dc_head + k;
              }
              *dst = dc_acc;
            }
            dc_acc = 0.0f;
            ++dc_row;
            dc_begin = dc_end;
            dc_end = __ldg(ptr + dc_row + 1);
          }
          dc_acc += dp[u];
        }
      }
      for (int f = lane * kVec; f < d; f += kWarp * kVec) {
        float v[kVec];
        runs::load_vec<kVec>(da_acc + f, v);
#pragma unroll
        for (int u = 0; u < kEdges; ++u) {
          if (xrow[u] >= 0) {
            float xv[kVec];
            runs::ldg_vec<kVec>(x + xrow[u] + f, xv);
#pragma unroll
            for (int i = 0; i < kVec; ++i) v[i] = fmaf(dp[u], xv[i], v[i]);
          }
        }
        runs::store_vec<kVec>(da_acc + f, v);
      }
    }
  }
  if (lane == 0) {
    cross[k] = runs::target(dc_begin, dc_end, first, last) == runs::kTail
                   ? dc_row
                   : -1;
    switch (runs::target(dc_begin, dc_end, first, last)) {
      case runs::kHead:
        dc_head[k] = dc_acc;
        break;
      case runs::kTail:
        dc_tail[k] = dc_acc;
        break;
      default:
        dc[dc_row] = dc_acc;
    }
    if (last == n_edges) {  // the empty rows after the last edge
      for (int r = dc_row + 1; r < n_rows; ++r) dc[r] = 0.0f;
    }
  }
  for (int f = lane; f < d; f += kWarp) da_row[f] = da_acc[f];
}

// The second grid.  Blocks [0, da_blocks): da[f] = sum_k da_part[k, f], one
// block per 32 features, 32 warps striding over the runs, then the warps'
// sums in warp order.  The other blocks: dc of the rows that cross runs,
// dc[r] = dc_tail[k] + dc_head[k + 1] + ... + dc_head[k_end], a thread per
// run.
__global__ void __launch_bounds__(kWarp * kWarp)
r1l_bwd_fixup_kernel(const int* __restrict__ ptr,
                     const float* __restrict__ dc_head,
                     const float* __restrict__ dc_tail,
                     const int* __restrict__ cross,
                     const float* __restrict__ da_part, float* __restrict__ dc,
                     float* __restrict__ da, int n_rows, int64_t n_runs,
                     int run, int d, int da_blocks) {
  if (static_cast<int>(blockIdx.x) >= da_blocks) {
    const int64_t k =
        static_cast<int64_t>(blockIdx.x - da_blocks) * blockDim.x +
        threadIdx.x;
    int64_t k_end = 0;
    const int r = runs::crossing_row(ptr, cross, __ldg(ptr + n_rows), run, k,
                                     k_end);
    if (r < 0) return;
    float v = dc_tail[k];
#pragma unroll 8
    for (int64_t j = k + 1; j <= k_end; ++j) v += dc_head[j];
    dc[r] = v;
    return;
  }
  __shared__ float partial[kWarp][kWarp];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int f = blockIdx.x * kWarp + lane;
  float v = 0.0f;
  if (f < d) {
    for (int64_t r = warp; r < n_runs; r += kWarp) v += da_part[r * d + f];
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

size_t bwd_smem(int d, int n_warps) {
  return sizeof(float) * static_cast<size_t>(d) * (1 + n_warps);
}

constexpr size_t kMaxSmem = 48 * 1024;

// d = 0 is a shape: the logits are c[r] and dc does not vanish.
bool bad_shape(int n_rows, int d, int n_warps) {
  return n_rows <= 0 || d < 0 || n_warps < 1 || n_warps > kMaxWarps;
}

using FwdKernel = void (*)(const int*, const int*, const float*,
                          const float*, const float*, const int*, float,
                          float, float, float*, float*, FwdWs, int, int64_t,
                          int, int);

template <int kG, bool kDrop>
FwdKernel fwd_kernel_per(int per) {
  switch (per) {
    case 1:
      return r1l_fwd_kernel<kG, 1, kDrop>;
    case 2:
      return r1l_fwd_kernel<kG, 2, kDrop>;
    case 4:
      return r1l_fwd_kernel<kG, 4, kDrop>;
    default:
      return r1l_fwd_kernel<kG, 8, kDrop>;
  }
}

template <bool kDrop>
FwdKernel fwd_kernel(int group, int per) {
  switch (group) {
    case 8:
      return fwd_kernel_per<8, kDrop>(per);
    case 16:
      return fwd_kernel_per<16, kDrop>(per);
    default:
      return fwd_kernel_per<32, kDrop>(per);
  }
}

bool good_group(int group) {
  return group == 8 || group == 16 || group == 32;
}

}  // namespace

// All entry points launch on `stream`, do not synchronise, and return
// cudaGetLastError() after their launches (0 = launched).  `seed` is a
// device pointer to one int32, read only when rate > 0.  `scale` is the
// kept edges' factor 1/(1-rate), given by the caller in float32.

// Two grids: the runs (rows inside a run, head and tail pieces of the
// others), then the crossing rows' pieces merged in run order.  col
// [n_slots] in CSR order, n_slots >= ptr[n_rows] (the edge count is read
// from ptr on the card); out [n_rows, d], lse [n_rows]; ws [n_runs (2 d +
// 5)] float32 with n_runs = max(1, ceil(n_slots / run)); group the lanes an
// edge, 8, 16 or 32.
extern "C" int r1l_fwd_f32(const int* ptr, const int* col, const float* c,
                           const float* a, const float* x, const int* seed,
                           float rate, float scale, float slope, float* out,
                           float* lse, float* ws, int n_rows, int n_slots,
                           int run, int group, int d, int n_warps,
                           cudaStream_t stream) {
  if (bad_shape(n_rows, d, n_warps) || n_slots < 0 || run < 1 ||
      !good_group(group)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_runs = runs::count(n_slots, run);
  const FwdWs w = fwd_ws(ws, n_runs, d);
  const uintptr_t at = reinterpret_cast<uintptr_t>(x) |
                       reinterpret_cast<uintptr_t>(a) |
                       reinterpret_cast<uintptr_t>(out) |
                       reinterpret_cast<uintptr_t>(w.head_acc) |
                       reinterpret_cast<uintptr_t>(w.tail_acc);
  const int per = gat_runs::per_lane(group, d, at);
  const int tile = group * per;
  const dim3 grid(static_cast<unsigned>((n_runs + n_warps - 1) / n_warps),
                  static_cast<unsigned>(d > tile ? (d + tile - 1) / tile : 1));
  const FwdKernel kernel =
      rate > 0.0f ? fwd_kernel<true>(group, per) : fwd_kernel<false>(group, per);
  kernel<<<grid, n_warps * kWarp, 0, stream>>>(ptr, col, c, a, x, seed, rate,
                                               scale, slope, out, lse, w,
                                               n_rows, n_runs, run, d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  r1l_fwd_fixup_kernel<<<grid.x, n_warps * kWarp, 0, stream>>>(
      ptr, w, out, lse, n_rows, n_runs, run, d);
  return static_cast<int>(cudaGetLastError());
}

// Two grids: the runs (q, dpre, dc pieces and da partials), then the
// fixed-order da reduce and the dc of the rows that cross runs.  col, q and
// dpre [n_slots] in CSR order, n_slots >= ptr[n_rows] (the edge count is
// read from ptr on the card; q and dpre are 0 past it), dc [n_rows], da
// [d]; ws [3 n_runs + n_runs d] float32 with n_runs = max(1, ceil(n_slots /
// run)).
extern "C" int r1l_bwd_f32(const int* ptr, const int* col, const float* c,
                           const float* a, const float* x, const float* gout,
                           const float* out, const float* lse, const int* seed,
                           float rate, float scale, float slope, float* q,
                           float* dpre, float* dc, float* ws, float* da,
                           int n_rows, int n_slots, int run, int d,
                           int n_warps, cudaStream_t stream) {
  if (bad_shape(n_rows, d, n_warps) || n_slots < 0 || run < 1 ||
      bwd_smem(d, n_warps) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_runs = runs::count(n_slots, run);
  float* dc_head = ws;
  float* dc_tail = ws + n_runs;
  int* cross = reinterpret_cast<int*>(ws + 2 * n_runs);
  float* da_part = ws + 3 * n_runs;
  const size_t smem = bwd_smem(d, n_warps);
  const unsigned blocks =
      static_cast<unsigned>((n_runs + n_warps - 1) / n_warps);
  const uintptr_t at = reinterpret_cast<uintptr_t>(x) |
                       reinterpret_cast<uintptr_t>(gout);
  const int vec = (d >= 128 && d % 4 == 0 && at % 16 == 0)  ? 4
                  : (d >= 64 && d % 2 == 0 && at % 8 == 0) ? 2
                                                            : 1;
  const bool drop = rate > 0.0f;
  auto kernel = drop ? (vec == 4   ? r1l_bwd_kernel<4, true>
                        : vec == 2 ? r1l_bwd_kernel<2, true>
                                   : r1l_bwd_kernel<1, true>)
                     : (vec == 4   ? r1l_bwd_kernel<4, false>
                        : vec == 2 ? r1l_bwd_kernel<2, false>
                                   : r1l_bwd_kernel<1, false>);
  kernel<<<blocks, n_warps * kWarp, smem, stream>>>(
      ptr, col, c, a, x, gout, out, lse, seed, rate, scale, slope, q, dpre,
      dc, dc_head, dc_tail, cross, da_part, n_rows, n_slots, n_runs, run, d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int da_blocks = (d + kWarp - 1) / kWarp;
  const int64_t dc_blocks = (n_runs + kWarp * kWarp - 1) / (kWarp * kWarp);
  r1l_bwd_fixup_kernel<<<static_cast<unsigned>(da_blocks + dc_blocks),
                         kWarp * kWarp, 0, stream>>>(
      ptr, dc_head, dc_tail, cross, da_part, dc, da, n_rows, n_runs, run, d,
      da_blocks);
  return static_cast<int>(cudaGetLastError());
}

// The keep scale of slots 0..n-1, by the kernels' own device function: the
// materialised GAT path's attention dropout.
extern "C" int r1l_keep_scale_f32(const int* seed, float rate, float scale,
                                  int n, float* out, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  r1l_keep_scale_kernel<<<(n + 255) / 256, 256, 0, stream>>>(seed, rate, scale,
                                                             n, out);
  return static_cast<int>(cudaGetLastError());
}

// The largest warps per block (1..8) for both kernels at feature width d:
// the forward takes any (it keeps no shared memory), the backward as many
// as its shared memory fits; 0 when even one warp does not fit.
extern "C" int r1l_max_warps(int d) {
  for (int w = kMaxWarps; w >= 1; --w) {
    if (bwd_smem(d, w) <= kMaxSmem) return w;
  }
  return 0;
}

extern "C" const char* r1l_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
