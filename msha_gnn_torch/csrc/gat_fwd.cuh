// The GAT forwards on the edge-run schedule: r1l_fwd_f32 and r1_fwd_f32
// (rank1_gat.cu) and flash_fwd_f32 (flash_gat.cu), one walk that differs
// only in where an edge's logit comes from (the logit source, a template
// tag):
//
//   kDot    l_e = leaky(c[r] + <x[j], a>, slope)   the rank-1 GAT with a
//                                                  destination-linear t
//   kRead   l_e = logits[e]                        flash-GAT
//   kRank1  l_e = leaky(c[r] + t[j], slope)        the generic rank-1 GAT
//
// and, for a CSR graph (row r has edges e in [ptr[r], ptr[r+1]), j =
// col[e]),
//
//   p_e    = exp(l_e - max_row l)          (softmax stats over UNdropped p)
//   k_e    = keep scale of slot e: 1/(1-rate) if kept, 0 if dropped, 1 at
//            rate 0 (gat::keep_scale, the hash of the TPU kernels' _hash01)
//   out[r] = sum_e p_e k_e x[j] / sum_e p_e,   lse[r] = max + log(sum p)
//
// with out = 0 and lse = NEG (-1e30) for an empty row.
//
// Grid 1: a warp per run of `run` consecutive CSR slots (runs.cuh), so a
// long row is spread over as many warps as it has runs.  The warp is split
// into groups of G lanes (8, 16 or 32), one edge a group (gat_runs.cuh): a
// lane holds kPer of the features of x[j] in registers, and each group
// keeps its own online softmax (m, s, acc) of the row piece, taking every
// (32 / G)-th edge of it, kSteps edges a step.  The logit source is told
// c[r] when the walk enters a row piece; it loads its per-edge input (the
// logit, or t[j]) with the step's rows of x, and forms the logit after
// (kDot: a group dot and a log2(G)-round shuffle sum).  At the end of a
// row piece the groups merge in a fixed order by shuffles; a row that lies
// inside the run is written, a row that crosses the run's ends leaves its
// piece (m, s, acc[d]) in the run's head or tail partial.
//
// Grid 2 (the fix-up): a warp per run k merges the row that begins in it
// and ends after it in run order, tail[k] (+) head[k + 1] (+) ... (+)
// head[k_end], and writes it.  runs.cuh says which run writes what, and
// who zeroes the empty rows.
//
// A width d that one group's registers do not cover takes several tiles of
// features (blockIdx.y); each tile forms the full logits in the same order
// (kRead and kRank1 trivially: a load), so all tiles see one softmax.  No
// float atomics: two launches give the same bits.
//
// x's rows may be stored in bfloat16 (r1l_fwd_bf16, the row type a
// template parameter): a lane widens its features to float as it loads
// them, so kDot's t_j, the logits, the softmax and the aggregation are
// float32 over the bfloat16 rows.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "gat_common.cuh"
#include "gat_runs.cuh"
#include "runs.cuh"

namespace gat_fwd {

using gat::kNeg;
using gat::kWarp;

constexpr int kMaxWarps = 8;

enum class Logit { kDot, kRead, kRank1 };

// The inputs of the logit sources; a source reads only its own.
struct LogitArgs {
  const float* logits;  // kRead: [>= E], CSR order
  const float* c;       // kDot, kRank1: [n_rows]
  const float* a;       // kDot: [d]
  const float* t;       // kRank1: [n_cols]
  float slope;          // kDot, kRank1
};

// Where an edge's logit comes from, as one lane of a group sees it.
template <Logit kSrc, int kG, int kPer>
struct LogitSource {
  LogitArgs p;
  float c_row = 0.0f;
  float av[kPer];  // kDot: the lane's features of a in this tile

  __device__ __forceinline__ LogitSource(const LogitArgs& args, int base,
                                         int d, int li)
      : p(args) {
    if constexpr (kSrc == Logit::kDot) {
      gat_runs::load_lane<kG, kPer>(p.a, base, d, li, av);
    }
  }

  // The walk enters row `row`.
  __device__ __forceinline__ void enter(int row) {
    if constexpr (kSrc != Logit::kRead) c_row = __ldg(p.c + row);
  }

  // The edge's own input, loaded beside its row of x: the logit of slot e
  // (kRead), t[j] (kRank1), nothing (kDot).
  __device__ __forceinline__ float load(int e, int j) const {
    if constexpr (kSrc == Logit::kRead) {
      return __ldg(p.logits + e);
    } else if constexpr (kSrc == Logit::kRank1) {
      return __ldg(p.t + j);
    } else {
      return 0.0f;
    }
  }

  // The logit from `v` (what load gave) and, for kDot, the lane's features
  // xv of x[j] (xr: the row, for the tiles this lane does not hold).
  // Every lane of the warp calls it: kDot sums over the group by shuffles.
  template <typename T>
  __device__ __forceinline__ float logit(float v, bool ok,
                                         const float (&xv)[kPer],
                                         const T* __restrict__ xr, int base,
                                         int d, int li) const {
    if constexpr (kSrc == Logit::kRead) {
      return v;
    } else if constexpr (kSrc == Logit::kRank1) {
      return gat::leaky(c_row + v, p.slope);
    } else {
      const float t = gat_runs::group_sum<kG>(
          ok ? gat_runs::lane_dot<kG, kPer>(xv, av, xr, p.a, base, d, li)
             : 0.0f);
      return gat::leaky(c_row + t, p.slope);
    }
  }
};

// Where the workspace keeps the pieces of the rows that cross runs:
// [n_runs, d] of acc for the head and the tail pieces, then m and s of
// each, then cross (int32), all [n_runs]: n_runs (2 d + 5) floats.
struct FwdWs {
  float* head_acc;
  float* tail_acc;
  float* head_m;
  float* head_s;
  float* tail_m;
  float* tail_s;
  int* cross;
};

inline FwdWs fwd_ws(float* ws, int64_t n_runs, int d) {
  float* scalars = ws + 2 * n_runs * d;
  return {ws,
          ws + n_runs * d,
          scalars,
          scalars + n_runs,
          scalars + 2 * n_runs,
          scalars + 3 * n_runs,
          reinterpret_cast<int*>(scalars + 4 * n_runs)};
}

// Grid 1: one warp per run of `run` CSR slots, groups of kG lanes one edge
// each, blockIdx.y the tile of kG kPer features this block aggregates; T
// the type of x's rows.
template <Logit kSrc, int kG, int kPer, bool kDrop, typename T>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
fwd_runs_kernel(const int* __restrict__ ptr, const int* __restrict__ col,
                LogitArgs args, const T* __restrict__ x,
                const int* __restrict__ seed_ptr, float rate, float scale,
                float* __restrict__ out, float* __restrict__ lse, FwdWs ws,
                int n_rows, int64_t n_runs, int run, int d) {
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
  LogitSource<kSrc, kG, kPer> src(args, base, d, li);
  const uint32_t seed = kDrop ? static_cast<uint32_t>(__ldg(seed_ptr)) : 0u;
  int row = r0;
  int rb = __ldg(ptr + row);
  int re = __ldg(ptr + row + 1);
  while (true) {
    // the piece [pb, pe) of the row: group grp takes every kGroups-th edge
    const int pb = max(rb, first);
    const int pe = min(re, last);
    src.enter(row);
    gat_runs::Piece<kPer> st;
    st.reset();
    // a step's columns are loaded a step ahead, so their latency hides
    // behind the step before
    int j_next[kSteps];
    gat_runs::load_step<kSteps, kGroups>(col, pb, pe, grp, j_next);
    for (int eb = pb; eb < pe; eb += kGroups * kSteps) {
      bool ok[kSteps];
      int64_t xrow[kSteps];
      float v[kSteps];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int e = eb + u * kGroups + grp;
        ok[u] = e < pe;
        xrow[u] = static_cast<int64_t>(j_next[u]) * d;
        v[u] = ok[u] ? src.load(e, j_next[u]) : 0.0f;
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
        l[u] = src.logit(v[u], ok[u], xv[u], x + xrow[u], base, d, li);
        keep[u] = kDrop ? gat::keep_scale(static_cast<uint32_t>(
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
        float o[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          o[i] = st.s > 0.0f ? st.acc[i] / st.s : 0.0f;
        }
        gat_runs::store_lane<kG, kPer>(out + static_cast<int64_t>(row) * d,
                                       base, d, li, o);
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

// Grid 2: a warp per run k, which merges the row r that begins in it and
// ends after it (cross[k]) in run order and writes out[r] = acc / s and
// lse[r] = m + log s.  A lane merges kFixFeatures features at once (lanes
// over features, 128 a pass: one pass at d <= 128), and the chain's loop
// is unrolled so that the loads of several pieces are in flight together:
// a long row's chain (30 pieces for the 3,842-edge row at 128 slots a
// run) is not walked at one memory latency a piece.
constexpr int kFixFeatures = 4;

__global__ void __launch_bounds__(kMaxWarps * kWarp)
fwd_fixup_kernel(const int* __restrict__ ptr, FwdWs ws,
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

template <typename T>
using FwdKernel = void (*)(const int*, const int*, LogitArgs, const T*,
                           const int*, float, float, float*, float*, FwdWs,
                           int, int64_t, int, int);

template <Logit kSrc, int kG, bool kDrop, typename T>
FwdKernel<T> kernel_per(int per) {
  switch (per) {
    case 1:
      return fwd_runs_kernel<kSrc, kG, 1, kDrop, T>;
    case 2:
      return fwd_runs_kernel<kSrc, kG, 2, kDrop, T>;
    case 4:
      return fwd_runs_kernel<kSrc, kG, 4, kDrop, T>;
    default:
      return fwd_runs_kernel<kSrc, kG, 8, kDrop, T>;
  }
}

template <Logit kSrc, bool kDrop, typename T>
FwdKernel<T> kernel_for(int group, int per) {
  switch (group) {
    case 8:
      return kernel_per<kSrc, 8, kDrop, T>(per);
    case 16:
      return kernel_per<kSrc, 16, kDrop, T>(per);
    default:
      return kernel_per<kSrc, 32, kDrop, T>(per);
  }
}

// Both grids on `stream`, no synchronisation; returns cudaGetLastError()
// after the launches (0 = launched).  col [n_slots] in CSR order, n_slots
// >= ptr[n_rows] (the edge count is read from ptr on the card); x
// [n_cols, d]; out [n_rows, d], lse [n_rows]; ws [n_runs (2 d + 5)] float32
// with n_runs = max(1, ceil(n_slots / run)); group the lanes an edge, 8,
// 16 or 32.  `seed` (a device pointer to one int32) is read when rate > 0;
// kRank1 takes no dropout.  x's rows are of type T: float, or
// __nv_bfloat16 for the bfloat16 payload.
template <Logit kSrc, typename T = float>
int launch(const int* ptr, const int* col, const LogitArgs& args,
           const T* x, const int* seed, float rate, float scale,
           float* out, float* lse, float* ws, int n_rows, int n_slots,
           int run, int group, int d, int n_warps, cudaStream_t stream) {
  if (n_rows <= 0 || d < 0 || n_warps < 1 || n_warps > kMaxWarps ||
      n_slots < 0 || run < 1 || !(group == 8 || group == 16 || group == 32) ||
      (kSrc == Logit::kRank1 && rate > 0.0f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_runs = runs::count(n_slots, run);
  const FwdWs w = fwd_ws(ws, n_runs, d);
  const uintptr_t at = runs::float_at(x) |
                       reinterpret_cast<uintptr_t>(args.a) |
                       reinterpret_cast<uintptr_t>(out) |
                       reinterpret_cast<uintptr_t>(w.head_acc) |
                       reinterpret_cast<uintptr_t>(w.tail_acc);
  const int per = gat_runs::per_lane(group, d, at);
  const int tile = group * per;
  const dim3 grid(static_cast<unsigned>((n_runs + n_warps - 1) / n_warps),
                  static_cast<unsigned>(d > tile ? (d + tile - 1) / tile : 1));
  FwdKernel<T> kernel = kernel_for<kSrc, false, T>(group, per);
  if constexpr (kSrc != Logit::kRank1) {
    if (rate > 0.0f) kernel = kernel_for<kSrc, true, T>(group, per);
  }
  kernel<<<grid, n_warps * kWarp, 0, stream>>>(ptr, col, args, x, seed, rate,
                                               scale, out, lse, w, n_rows,
                                               n_runs, run, d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fwd_fixup_kernel<<<grid.x, n_warps * kWarp, 0, stream>>>(
      ptr, w, out, lse, n_rows, n_runs, run, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gat_fwd
