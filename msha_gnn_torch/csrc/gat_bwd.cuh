// The per-edge walks on the edge-run schedule whose main outputs are one
// value an edge: flash_bwd_f32 and r1_bwd_f32 (flash_gat.cu),
// csr_sddmm_f32 (sddmm.cu) and csr_spmm_dw_f32 (spmm.cu), one walk that
// differs only in what it does with an edge's dot (the source, a template
// tag).  For a CSR graph (row r has edges e in [ptr[r], ptr[r+1]), j =
// col[e]) every edge forms
//
//   gx_e = <a[r], b[j]>
//
// and then, by source:
//
//   kNone   out_e = gx_e                                   (csr_sddmm_f32)
//   kRead   l_e = logits[e]                                (flash_bwd_f32)
//   kRank1  pre_e = c[r] + t[j],  l_e = leaky(pre_e)       (r1_bwd_f32)
//   kDw     dw[id_e] = gx_e,  dx[r] = sum_{e in r} w[id_e] b[j]
//                                                        (csr_spmm_dw_f32)
//
// with, for the two softmax backwards (a = gout, b = x, `out` and `lse` the
// forward's),
//
//   att_e = exp(l_e - lse[r]), 0 where lse[r] <= NEG/2,   q_e = att_e k_e,
//   dl_e  = q_e gx_e - att_e <gout[r], out[r]>
//
// (k_e the keep scale of slot e, kRead only; 1 without dropout).  kRead
// writes dl and q; kRank1 writes att and dpre_e = dl_e (pre_e >= 0 ? 1 :
// slope), and dc[r] = sum_{e in r} dpre_e.  kDw (a = x, the rows' own; b =
// g, the cotangent gathered; id_e = eid[e], or e without an edge map) is a
// weighted SpMM's backward: each gathered row b[j] serves both the dot and
// the row sum.  dc and dx are the outputs that sum over a row.  kDw's
// rows a and b may be stored in bfloat16 (csr_spmm_dw_bf16), and so may
// kRank1's x (r1_bwd_bf16; gout stays float32): the row types are template
// parameters, the rows are widened to float as they are loaded, and every
// dot and sum is float32.
//
// Grid 1: a warp per run of `run` consecutive slots of [0, n_slots)
// (runs.cuh), so a long row is spread over as many warps as it has runs;
// the run's slots past ptr[n_rows] (pads) get 0 (kDw: dw's slots past
// ptr[n_rows], by slot, not through eid).  The warp is split into groups of
// G lanes (8, 16 or 32), one edge a group (gat_runs.cuh).  For each row
// piece the warp holds a[r] in registers (d / G floats a lane) and, for the
// softmax backwards, forms <gout[r], out[r]> and reads lse[r] (and c[r])
// once; a group's dot <a[r], b[j]> is a float4-wide multiply-add a lane and
// a log2(G)-round shuffle sum, and one lane of the group does the edge's
// scalar work and its stores.  The per-edge input (logits[e], t[j], w[id_e])
// is loaded beside the edge's column.
//
// The row sums: kRank1's lanes sum their edges' dpre, and at the end of a
// row piece the warp adds them by a butterfly (a fixed order).  kDw's groups
// each keep acc[kPer] += w b[j] over their edges, and at the end of a row
// piece the groups' accumulators are added by shuffles in a fixed order
// (group 0 with group 1, then with the sum of 2 and 3, ...), the plain-sum
// counterpart of gat_runs::merge_groups.  runs.cuh says where the piece
// goes (its row, or the run's head or tail partial with cross[k]) and which
// run zeroes an empty row; the fix-up grids (runs::fixup_kernel, two
// levels: threads over runs for dc, warps over runs for dx) add the rows
// that cross runs.  The other sources sum nothing over a row and have one
// grid.
//
// A width d above what one group's registers hold takes several tiles:
// the lanes keep the first tile of a[r] and stream the others
// (gat_runs::lane_dot).  kDw's dx is tiled by blockIdx.y (each block sums
// its tile of features, and forms the full dot again: only the blocks of
// tile 0 store dw and the pads); the other sources take one tile.  No float
// atomics: two launches give the same bits.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "gat_common.cuh"
#include "gat_runs.cuh"
#include "runs.cuh"

namespace gat_bwd {

using gat::kNeg;
using gat::kWarp;

constexpr int kMaxWarps = 8;

enum class Src { kNone, kRead, kRank1, kDw };

// The inputs and outputs besides ptr, col, a and b, as the entry points
// give them; a source reads and writes only its own.  The kernel takes
// them as __restrict__ parameters.
struct Args {
  const float* logits;  // kRead: [>= E], CSR order
  const float* c;       // kRank1: [n_rows]
  const float* t;       // kRank1: [n_cols]
  const float* out;     // kRead, kRank1: the forward's out [n_rows, d]
  const float* lse;     // kRead, kRank1: [n_rows]
  const int* seed;      // kRead at rate > 0: one int32 on the card
  const int* eid;       // kDw: [>= E] the slot's id in w and dw, or null
  const float* w;       // kDw: the weights, read at id_e
  float rate;
  float scale;          // kRead: 1/(1-rate)
  float slope;          // kRank1
  float* o1;            // [n_slots] kNone: out; kRead: dl; kRank1: dpre;
                        // kDw: dw
  float* o2;            // [n_slots] kRead: q; kRank1: att
  float* sums;          // the row sums: kRank1 dc [n_rows]; kDw dx [n_rows, d]
  float* ws;            // kRank1, kDw: head | tail [n_runs, width] each, then
                        // cross [n_runs] (int32); width 1 (dc) or d (dx)
};

// Grid 1's walk: one warp per run of `run` slots, groups of kG lanes one
// edge each; kDw: blockIdx.y the tile of kG kPer features this block sums.
// TA, TB: the types of a's and b's rows.
template <Src kSrc, int kG, int kPer, bool kDrop, typename TA, typename TB>
__device__ __forceinline__ void walk(
    const int* __restrict__ ptr, const int* __restrict__ col,
    const TA* __restrict__ a, const TB* __restrict__ b,
    const float* __restrict__ logits, const float* __restrict__ c,
    const float* __restrict__ t, const float* __restrict__ out,
    const float* __restrict__ lse, const int* __restrict__ seed_ptr,
    const int* __restrict__ eid, const float* __restrict__ w, float rate,
    float scale, float slope, float* __restrict__ o1, float* __restrict__ o2,
    float* __restrict__ sums, float* __restrict__ ws, int n_rows, int n_slots,
    int64_t n_runs, int run, int d) {
  using L = gat_runs::Layout<kG, kPer>;
  constexpr bool kSoftmax = kSrc == Src::kRead || kSrc == Src::kRank1;
  constexpr bool kDc = kSrc == Src::kRank1;
  constexpr bool kDx = kSrc == Src::kDw;
  constexpr int kGroups = kWarp / kG;
  constexpr int kSteps = L::kSteps;
  const int n_warps = blockDim.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int li = lane % kG;
  const int grp = lane / kG;
  const int64_t k =
      static_cast<int64_t>(blockIdx.x) * n_warps + threadIdx.x / kWarp;
  if (k >= n_runs) return;
  // kDw's tile of features, and whether this block stores the per-edge
  // outputs (the others take one tile: known at compile time)
  const int base = kDx ? blockIdx.y * L::kTile : 0;
  const bool lead = !kDx || blockIdx.y == 0;
  const int width = kDx ? d : 1;      // of a row sum
  float* head = ws;
  float* tail = ws + n_runs * width;
  // an empty row: dc, or this tile of dx
  auto zero_row = [&](int r) {
    if constexpr (kDc) {
      if (lane == 0) sums[r] = 0.0f;
    } else if constexpr (kDx) {
      for (int f = base + lane; f < min(d, base + L::kTile); f += kWarp) {
        sums[static_cast<int64_t>(r) * d + f] = 0.0f;
      }
    }
  };
  const int n_edges = __ldg(ptr + n_rows);
  // the pads in the run's slots
  const int64_t slot_end =
      (k + 1) * run < n_slots ? (k + 1) * run : static_cast<int64_t>(n_slots);
  for (int64_t e = (k * run > n_edges ? k * run : n_edges) + lane;
       lead && e < slot_end; e += kWarp) {
    o1[e] = 0.0f;
    if constexpr (kSoftmax) o2[e] = 0.0f;
  }
  int first = 0;
  int last = 0;
  if (!runs::bounds(k, run, n_edges, first, last)) {  // past the last edge
    if (k == 0) {  // no edges at all
      for (int r = 0; r < n_rows; ++r) zero_row(r);
    }
    return;
  }
  const uint32_t seed = kDrop ? static_cast<uint32_t>(__ldg(seed_ptr)) : 0u;
  int row = runs::warp_row_of(ptr, n_rows, first, lane);
  for (int r = runs::first_owned(ptr, row, first); r < row; ++r) zero_row(r);
  int rb = __ldg(ptr + row);
  int re = __ldg(ptr + row + 1);
  while (true) {
    const int64_t off = static_cast<int64_t>(row) * d;
    float av[kPer];
    gat_runs::load_lane<kG, kPer>(a + off, base, d, li, av);
    float d_row = 0.0f;
    float lse_row = 0.0f;
    float c_row = 0.0f;
    bool live = false;
    if constexpr (kSoftmax) {
      float ov[kPer];
      gat_runs::load_lane<kG, kPer>(out + off, base, d, li, ov);
      d_row = gat_runs::group_sum<kG>(gat_runs::lane_dot<kG, kPer>(
          av, ov, a + off, out + off, base, d, li));
      lse_row = __ldg(lse + row);
      live = lse_row > 0.5f * kNeg;
    }
    if constexpr (kDc) c_row = __ldg(c + row);
    float dc_lane = 0.0f;  // kRank1: this lane's edges' dpre in the piece
    float acc[kPer];       // kDw: the group's sum of w b[j], this lane's part
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] = 0.0f;
    const int pe = min(re, last);
    for (int eb = max(rb, first); eb < pe; eb += kGroups * kSteps) {
      bool ok[kSteps];
      int64_t brow[kSteps];
      int id[kSteps];   // kDw: the edge's id in w and dw
      float v[kSteps];  // the edge's own input: logits[e], t[j] or w[id_e]
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int e = eb + u * kGroups + grp;
        ok[u] = e < pe;
        id[u] = e;
        if constexpr (kSrc == Src::kRank1) {
          const int j = ok[u] ? __ldg(col + e) : 0;
          brow[u] = static_cast<int64_t>(j) * d;
          v[u] = ok[u] ? __ldg(t + j) : 0.0f;
        } else {
          // as the 64-bit product of the column: ptxas keeps it once
          brow[u] = ok[u] ? static_cast<int64_t>(__ldg(col + e)) * d : 0;
          v[u] = kSrc == Src::kRead && ok[u] ? __ldg(logits + e) : 0.0f;
          if constexpr (kDx) {
            if (ok[u] && eid != nullptr) id[u] = __ldg(eid + e);
          }
        }
      }
      if constexpr (kDx) {
#pragma unroll
        for (int u = 0; u < kSteps; ++u) v[u] = ok[u] ? __ldg(w + id[u]) : 0.0f;
      }
      float bv[kSteps][kPer];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        if (ok[u]) {
          gat_runs::load_lane<kG, kPer>(b + brow[u], base, d, li, bv[u]);
        } else {
#pragma unroll
          for (int i = 0; i < kPer; ++i) bv[u][i] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const float gx = gat_runs::group_sum<kG>(
            ok[u] ? gat_runs::lane_dot<kG, kPer>(bv[u], av, b + brow[u],
                                                  a + off, base, d, li)
                  : 0.0f);
        if constexpr (kDx) {
          if (ok[u]) {
#pragma unroll
            for (int i = 0; i < kPer; ++i) {
              acc[i] = fmaf(v[u], bv[u][i], acc[i]);
            }
          }
        }
        if (ok[u] && li == u % kG) {
          const int e = eb + u * kGroups + grp;
          if constexpr (kSrc == Src::kNone) {
            o1[e] = gx;
          } else if constexpr (kDx) {
            if (lead) o1[id[u]] = gx;
          } else {
            float pre = 0.0f;
            float l = v[u];
            if constexpr (kDc) {
              pre = c_row + v[u];
              l = gat::leaky(pre, slope);
            }
            const float att = live ? expf(l - lse_row) : 0.0f;
            const float qe =
                kDrop ? att * gat::keep_scale(static_cast<uint32_t>(e), seed,
                                              rate, scale)
                      : att;
            const float dl = qe * gx - att * d_row;
            if constexpr (kDc) {
              const float dp = pre >= 0.0f ? dl : slope * dl;
              o1[e] = dp;
              o2[e] = att;
              dc_lane += dp;
            } else {
              o1[e] = dl;
              o2[e] = qe;
            }
          }
        }
      }
    }
    const runs::Target to = runs::target(rb, re, first, last);
    if constexpr (kDc) {
      const float dc_piece = gat::warp_sum(dc_lane);
      if (lane == 0) {
        float* dst = to == runs::kHead   ? head + k
                     : to == runs::kTail ? tail + k
                                         : sums + row;
        *dst = dc_piece;
      }
    }
    if constexpr (kDx) {
#pragma unroll
      for (int o = kG; o < kWarp; o *= 2) {
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          acc[i] += __shfl_xor_sync(gat::kFull, acc[i], o);
        }
      }
      if (grp == 0) {
        float* dst = to == runs::kHead   ? head + k * d
                     : to == runs::kTail ? tail + k * d
                                         : sums + off;
        gat_runs::store_lane<kG, kPer>(dst, base, d, li, acc);
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
  if constexpr (kDc || kDx) {
    if (lead && lane == 0) {
      reinterpret_cast<int*>(ws + 2 * n_runs * width)[k] =
          runs::cross_code(row, rb, re, first, last);
    }
    if (last == n_edges) {  // the empty rows after the last edge
      for (int r = row + 1; r < n_rows; ++r) zero_row(r);
    }
  }
}

// Grid 1 of every source but kDw; a's rows float, b's of type TB.
template <Src kSrc, int kG, int kPer, bool kDrop, typename TB>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
runs_kernel(
    const int* __restrict__ ptr, const int* __restrict__ col,
    const float* __restrict__ a, const TB* __restrict__ b,
    const float* __restrict__ logits, const float* __restrict__ c,
    const float* __restrict__ t, const float* __restrict__ out,
    const float* __restrict__ lse, const int* __restrict__ seed_ptr,
    const int* __restrict__ eid, const float* __restrict__ w, float rate,
    float scale, float slope, float* __restrict__ o1, float* __restrict__ o2,
    float* __restrict__ sums, float* __restrict__ ws, int n_rows, int n_slots,
    int64_t n_runs, int run, int d) {
  walk<kSrc, kG, kPer, kDrop, float, TB>(
      ptr, col, a, b, logits, c, t, out, lse, seed_ptr, eid, w, rate, scale,
      slope, o1, o2, sums, ws, n_rows, n_slots, n_runs, run, d);
}

// Grid 1 of kDw, which holds x[r], a step's gathered rows and its row sum:
// capped at 80 registers, so that 3 blocks of 8 warps share an SM
// (uncapped it held 97, and 2 fit).  The other sources keep the
// compiler's own register choice.
template <int kG, int kPer, typename T>
__global__ void __launch_bounds__(kMaxWarps * kWarp, 3)
dw_runs_kernel(
    const int* __restrict__ ptr, const int* __restrict__ col,
    const T* __restrict__ a, const T* __restrict__ b,
    const float* __restrict__ logits, const float* __restrict__ c,
    const float* __restrict__ t, const float* __restrict__ out,
    const float* __restrict__ lse, const int* __restrict__ seed_ptr,
    const int* __restrict__ eid, const float* __restrict__ w, float rate,
    float scale, float slope, float* __restrict__ o1, float* __restrict__ o2,
    float* __restrict__ sums, float* __restrict__ ws, int n_rows, int n_slots,
    int64_t n_runs, int run, int d) {
  walk<Src::kDw, kG, kPer, false, T, T>(
      ptr, col, a, b, logits, c, t, out, lse, seed_ptr, eid, w, rate, scale,
      slope, o1, o2, sums, ws, n_rows, n_slots, n_runs, run, d);
}

template <typename TA, typename TB>
using Kernel = void (*)(const int*, const int*, const TA*, const TB*,
                        const float*, const float*, const float*,
                        const float*, const float*, const int*, const int*,
                        const float*, float, float, float, float*, float*,
                        float*, float*, int, int, int64_t, int, int);

template <Src kSrc, int kG, int kPer, bool kDrop, typename TA, typename TB>
Kernel<TA, TB> kernel_of() {
  if constexpr (kSrc == Src::kDw) {
    static_assert(std::is_same_v<TA, TB>, "kDw's a and b share a row type");
    return dw_runs_kernel<kG, kPer, TA>;
  } else {
    static_assert(std::is_same_v<TA, float> &&
                      (kSrc == Src::kRank1 || std::is_same_v<TB, float>),
                  "bfloat16 rows: kDw's a and b, kRank1's b");
    return runs_kernel<kSrc, kG, kPer, kDrop, TB>;
  }
}

template <Src kSrc, int kG, bool kDrop, typename TA, typename TB>
Kernel<TA, TB> kernel_per(int per) {
  switch (per) {
    case 1:
      return kernel_of<kSrc, kG, 1, kDrop, TA, TB>();
    case 2:
      return kernel_of<kSrc, kG, 2, kDrop, TA, TB>();
    case 4:
      return kernel_of<kSrc, kG, 4, kDrop, TA, TB>();
    default:
      return kernel_of<kSrc, kG, 8, kDrop, TA, TB>();
  }
}

template <Src kSrc, bool kDrop, typename TA, typename TB>
Kernel<TA, TB> kernel_for(int group, int per) {
  switch (group) {
    case 8:
      return kernel_per<kSrc, 8, kDrop, TA, TB>(per);
    case 16:
      return kernel_per<kSrc, 16, kDrop, TA, TB>(per);
    default:
      return kernel_per<kSrc, 32, kDrop, TA, TB>(per);
  }
}

// The grids on `stream`, no synchronisation; returns cudaGetLastError()
// after the launches (0 = launched).  col [>= ptr[n_rows]] in CSR order (the
// edge count is read from ptr on the card), a [n_rows, d], b [n_cols, d];
// o1 (and o2) [n_slots] with n_slots >= ptr[n_rows]; group the lanes an
// edge, 8, 16 or 32.  kRank1: sums = dc [n_rows]; kDw: sums = dx [n_rows,
// d]; ws float32, the runs' and the fix-up chunks' partials at the sums'
// width w (1 or d): (n_runs + n_chunks) (2 w + 1) floats, n_runs = max(1,
// ceil(n_slots / run)), n_chunks = ceil(n_runs / runs::chunk_runs(w)).  Dropout (rate > 0) is kRead's only; rows of a
// type other than float are kDw's (a and b, TA = TB) and kRank1's b.
template <Src kSrc, typename TA = float, typename TB = TA>
int launch(const int* ptr, const int* col, const TA* a, const TB* b,
           const Args& p, int n_rows, int n_slots, int run, int group, int d,
           int n_warps, cudaStream_t stream) {
  if (n_rows <= 0 || d < 0 || n_warps < 1 || n_warps > kMaxWarps ||
      n_slots < 0 || run < 1 || !(group == 8 || group == 16 || group == 32) ||
      (kSrc != Src::kRead && p.rate > 0.0f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_runs = runs::count(n_slots, run);
  uintptr_t at = runs::float_at(a) | runs::float_at(b);
  if constexpr (kSrc == Src::kRead || kSrc == Src::kRank1) {
    at |= reinterpret_cast<uintptr_t>(p.out);
  }
  if constexpr (kSrc == Src::kDw) {
    at |= reinterpret_cast<uintptr_t>(p.sums) |
          reinterpret_cast<uintptr_t>(p.ws);
  }
  const int per = gat_runs::per_lane(group, d, at);
  const int tile = group * per;
  const dim3 grid(
      static_cast<unsigned>((n_runs + n_warps - 1) / n_warps),
      static_cast<unsigned>(kSrc == Src::kDw && d > tile
                                ? (d + tile - 1) / tile : 1));
  Kernel<TA, TB> kernel = kernel_for<kSrc, false, TA, TB>(group, per);
  if constexpr (kSrc == Src::kRead) {
    if (p.rate > 0.0f) kernel = kernel_for<kSrc, true, TA, TB>(group, per);
  }
  kernel<<<grid, n_warps * kWarp, 0, stream>>>(
      ptr, col, a, b, p.logits, p.c, p.t, p.out, p.lse, p.seed, p.eid, p.w,
      p.rate, p.scale, p.slope, p.o1, p.o2, p.sums, p.ws, n_rows, n_slots,
      n_runs, run, d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (kSrc == Src::kRank1 || kSrc == Src::kDw) {
    return runs::fixup(ptr, p.ws, p.sums, n_rows, n_runs, run,
                       kSrc == Src::kDw ? d : 1, stream);
  }
  return 0;
}

}  // namespace gat_bwd
