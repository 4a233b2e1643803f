// CSR walks, summed in float32:
//
// csr_spmm_f32: sparse (CSR) times dense,
//
//   out[r, :] = sum_{e = ptr[r]}^{ptr[r+1]-1} w[e] * x[col[e], :]
//
// with w[e] = 1 when w is null (an unweighted reduce reads no weights).
//
// seg_reduce_f32: the same walk with col[e] = e and unit weights, the
// sorted segment sum (no column or weight array is read),
//
//   out[r, :] = sum_{e = ptr[r]}^{ptr[r+1]-1} values[e, :]
//
// csr_spmm_dw_f32: the weighted walk of a weighted SpMM's backward, which
// also writes each edge's weight gradient from the row it already holds,
//
//   dx[r, :]   = sum_{e in row r} w[id_e] * g[col[e], :]
//   dw[id_e]   = <g[col[e], :], x[r, :]>,   id_e = eid[e] (e when null)
//
// with the slots [ptr[n_rows], n_slots) of dw zeroed.  For A @ x the
// caller walks the CSC (eid = the CSC -> CSR edge map, so dw lands in CSR
// order and each slot is written once); for A.T @ x it walks the CSR (eid
// null).
//
// csr_spmm_bf16 and csr_spmm_dw_bf16: the same two walks over rows stored
// in bfloat16 (x; g and x), the bfloat16 payload of the TPU kernels below
// (spmm.py:269-271, :315, :370, :774).  A row is widened to float32 in
// registers as it is loaded (runs::ldg_vec), and every product and sum is
// float32; w, dw and the outputs stay float32.  The row type is a template
// parameter of the one walk, so the two forms share every line but the
// load.  The TPU kernels also round v * w (the visit SpMM) or the per-hub
// sums (the hub SpMM) to bfloat16: those are their schedule's, not the
// function's, and the port's bfloat16 kernels keep them in float32.
//
// Replaces these TPU kernels of msha_gnn_tpu/ops/pallas/spmm.py:
//   * _visit_kernel (:244), csr_spmm_f32: a one-hot MXU reduce of CSR edge
//     chunks into 128-row output blocks, walked by a host-built
//     chunk-visit schedule;
//   * _hub_kernel (:747), csr_spmm_f32: the same reduce for edges whose
//     column is one of the top-H columns, served from an [H, d] table
//     composed on the MXU;
//   * _reduce_kernel (:81), seg_reduce_f32: one-hot MXU reduces of
//     E_CHUNK-edge windows of the sorted values into 128-row blocks;
//   * _visit_dw_kernel (:282) and _hub_dw_kernel (:340), csr_spmm_dw_f32:
//     the visit and hub reduces that also emit dw from the gathered rows,
//     with x's rows gathered by a transposed one-hot.
// The schedules and the hub table answer TPU limits: a row gather that is
// issue-bound and a matrix unit that wants 128-row blocks.  On Hopper a
// gathered row of d = 32 floats is one coalesced 128-byte load per warp,
// and a small x (the [32, 32] operand of the GCN's second layer) stays in
// L1/L2, so one CSR walk serves them all.
//
// Bound: bytes.  Each edge needs its column index and weight (8 B, or 4 B
// unweighted) and one row of x (seg_reduce_f32: its own row of values;
// csr_spmm_dw_f32 adds eid and the dw write, 8 B, and reads each row of x
// once; the bfloat16 forms read their rows at 2 B a value, half the row
// bytes); the operations (2 E d flops, 4 E d with dw) are far below the
// card's rate.  At the GCN's shapes each call moves about 6 MB at minimum,
// about 2 us at HBM rate; seg_reduce_f32 on [E, 64] values reads 84 MB,
// about 25 us; csr_spmm_dw_f32 on the linkpred graph at d 64 moves about
// 8.5 MB, about 2.5 us.
//
// Design of csr_spmm_f32 and seg_reduce_f32: the edge-run schedule of
// runs.cuh.  The first design, one block per output row, walked the longest
// row serially: the linkpred graph's 3,842-edge row, or the GCN's 32 CSC
// rows of about 3,168 edges on 32 of the 132 SMs, set the kernel's time
// alone, each warp reloading col and w for every 32-feature tile and each
// x load waiting on its own col load.  Now each warp takes a run of `run`
// consecutive slots, whatever the rows; a row crossing runs is added up
// from the runs' head and tail partials by the two-level fix-up of
// runs.cuh (a block a chunk of 512 runs at d = 1 and 64 above, joined in a
// fixed tree, then a worker a chunk over the chunks' partials).  Its
// first design, a worker a crossing row adding every partial in run order,
// left the out-of-core benchmark's hub row to one thread or warp: 1.230 /
// 0.613 ms a slice at d = 1 / 32, 42% of the step.  Inside a run, edges
// are the outer loop and features the inner: the warp loads 32 edges' col
// and w in one coalesced load and hands them to the lanes with
// __shfl_sync, then keeps kGroup edges' rows of x in flight; each lane
// loads kVec floats of a row (float4
// where d % 4 == 0 and d >= 128, float2 where d is even and d >= 64).  At
// d = 1 (a column sum of per-edge scalars) a warp would leave 31 lanes
// idle, so there a thread takes a run of its own.  No atomics: two
// launches on the same inputs give the same bits.
//
// Design of csr_spmm_dw_f32: the per-edge walk of gat_bwd.cuh (the source
// kDw), on the same edge runs.  Its first design ran one block per row: the
// longest row (3,842 edges on the linkpred graph) set its time, the GCN's
// 32 CSC rows kept 32 of the 132 SMs busy, and every edge ran a 32-lane
// warp sum for its dot while each lane held 2 of the 64 floats; it ran at
// 40-48x its bound, twice the time of the unfused backward it was meant to
// save.  Now a warp takes a run of `run` slots and is split into groups of
// G lanes, one edge a group.  For each row piece the lanes hold x[r] in
// registers; each gathered row g[col[e]] is loaded once and used twice: a
// group dot (a log2(G)-round shuffle sum, one lane storing dw[id_e]) and
// the group's own sum acc += w[id_e] g[col[e]].  At the end of a row piece
// the groups' sums are added in a fixed order and the row is written, or
// left as the run's head or tail partial; the fix-up grids of the sums
// (runs::fixup_kernel) add the rows that cross runs.  Widths
// above one group's tile (G x 8 floats, 64 at G 8 and 256 at G 32; fewer
// where the rows are not 16-byte aligned) take dx in tiles on blockIdx.y:
// each tile's blocks sum their features and form the full dot again
// (gat_runs::lane_dot streams the other tiles), and only tile 0 stores dw.
// That keeps registers at a tile's worth whatever d is, and costs one more
// read of the dot's rows a tile, off the paths that run d 64.  The walk is
// capped at 80 registers in blocks of 4 warps (kDwWarps), so 24 warps share
// an SM; runs of 128 slots and 8 lanes an edge at d 64 are the defaults
// (spmm.DW_RUN, rank1_gat.group_for), from the sweep in PERF.md.  No
// atomics: two launches give the same bits.

#include <cuda_runtime.h>

#include <cstdint>

#include "gat_bwd.cuh"
#include "runs.cuh"

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kWarpsPerBlock = 4;  // measured: 4 beat 8 on the att SpMM and segment sum
constexpr int kGroup = 8;     // edges whose rows of x are in flight together
constexpr int kD1Threads = 256;
// warps a block of csr_spmm_dw_f32: at its 80 registers 6 such blocks
// share an SM, a finer grain than 3 blocks of 8 warps
constexpr int kDwWarps = 4;

// The row the piece [begin, end) of run k goes to: out's row, or the run's
// head or tail partial (each [n_runs, d]).
__device__ __forceinline__ float* piece_dst(float* out, float* head,
                                            float* tail, int row, int begin,
                                            int end, int first, int last,
                                            int64_t k, int d) {
  switch (runs::target(begin, end, first, last)) {
    case runs::kHead:
      return head + k * d;
    case runs::kTail:
      return tail + k * d;
    default:
      return out + static_cast<int64_t>(row) * d;
  }
}

// One warp per run; lanes over kVec-wide slices of 32 kVec-feature tiles.
// kIdentity: the edge's own index is its row of x (col is not read).  T:
// the type of x's rows (float or __nv_bfloat16).
template <int kVec, bool kWeighted, bool kIdentity, typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
csr_spmm_runs_kernel(const int* __restrict__ ptr, const int* __restrict__ col,
                     const float* __restrict__ w, const T* __restrict__ x,
                     float* __restrict__ out, float* __restrict__ head,
                     float* __restrict__ tail, int* __restrict__ cross,
                     int n_rows, int run, int d) {
  const int lane = threadIdx.x % kWarp;
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                    threadIdx.x / kWarp;
  const int n_edges = __ldg(ptr + n_rows);
  int first = 0;
  int last = 0;
  if (!runs::bounds(k, run, n_edges, first, last)) {
    if (k == 0) {  // no edges: every row is empty
      for (int64_t i = lane; i < static_cast<int64_t>(n_rows) * d;
           i += kWarp) {
        out[i] = 0.0f;
      }
    }
    return;
  }
  const int r0 = runs::warp_row_of(ptr, n_rows, first, lane);
  const int r_owned = runs::first_owned(ptr, r0, first);
  for (int f0 = 0; f0 < d; f0 += kWarp * kVec) {
    const int f = f0 + lane * kVec;
    const bool mine = f < d;
    float acc[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = 0.0f;
    if (mine) {
      for (int r = r_owned; r < r0; ++r) {
        runs::store_vec<kVec>(out + static_cast<int64_t>(r) * d + f, acc);
      }
    }
    int row = r0;
    int begin = __ldg(ptr + row);
    int end = __ldg(ptr + row + 1);
    // each batch of 32 edges' col and w in one coalesced load, the next
    // batch's loaded while this one's rows of x are summed
    int next_src = 0;
    float next_w = 1.0f;
    if (first + lane < last) {
      next_src = kIdentity ? first + lane : __ldg(col + first + lane);
      if (kWeighted) next_w = __ldg(w + first + lane);
    }
    for (int b = first; b < last; b += kWarp) {
      const int n_b = min(kWarp, last - b);
      const int my_src = next_src;
      const float my_w = next_w;
      const int nb = b + kWarp + lane;
      if (nb < last) {
        next_src = kIdentity ? nb : __ldg(col + nb);
        if (kWeighted) next_w = __ldg(w + nb);
      }
      for (int g = 0; g < n_b; g += kGroup) {
        float v[kGroup][kVec];
        float wt[kGroup];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const int src = __shfl_sync(kFull, my_src, g + u);
          wt[u] = kWeighted ? __shfl_sync(kFull, my_w, g + u) : 1.0f;
          if (g + u < n_b && mine) {
            runs::ldg_vec<kVec>(x + static_cast<int64_t>(src) * d + f, v[u]);
          } else {
#pragma unroll
            for (int i = 0; i < kVec; ++i) v[u][i] = 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          if (g + u < n_b) {
            const int e = b + g + u;
            while (e >= end) {  // the row ends inside the run
              if (mine) {
                runs::store_vec<kVec>(piece_dst(out, head, tail, row, begin,
                                                end, first, last, k, d) + f,
                                      acc);
              }
#pragma unroll
              for (int i = 0; i < kVec; ++i) acc[i] = 0.0f;
              ++row;
              begin = end;
              end = __ldg(ptr + row + 1);
            }
#pragma unroll
            for (int i = 0; i < kVec; ++i) {
              acc[i] = kWeighted ? fmaf(wt[u], v[u][i], acc[i])
                                 : acc[i] + v[u][i];
            }
          }
        }
      }
    }
    if (lane == 0 && f0 == 0) {
      cross[k] = runs::cross_code(row, begin, end, first, last);
    }
    if (mine) {
      runs::store_vec<kVec>(piece_dst(out, head, tail, row, begin, end,
                                      first, last, k, d) + f, acc);
      if (last == n_edges) {  // the empty rows after the last edge
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[i] = 0.0f;
        for (int r = row + 1; r < n_rows; ++r) {
          runs::store_vec<kVec>(out + static_cast<int64_t>(r) * d + f, acc);
        }
      }
    }
  }
}

// d = 1: one thread per run, kGroup edges' loads in flight.
template <bool kWeighted, bool kIdentity, typename T>
__global__ void __launch_bounds__(kD1Threads)
csr_spmm_runs_d1_kernel(const int* __restrict__ ptr,
                        const int* __restrict__ col,
                        const float* __restrict__ w,
                        const T* __restrict__ x, float* __restrict__ out,
                        float* __restrict__ head, float* __restrict__ tail,
                        int* __restrict__ cross, int n_rows, int run) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int n_edges = __ldg(ptr + n_rows);
  int first = 0;
  int last = 0;
  if (!runs::bounds(k, run, n_edges, first, last)) {
    if (k == 0) {
      for (int r = 0; r < n_rows; ++r) out[r] = 0.0f;
    }
    return;
  }
  const int r0 = runs::row_of(ptr, n_rows, first);
  for (int r = runs::first_owned(ptr, r0, first); r < r0; ++r) out[r] = 0.0f;
  int row = r0;
  int begin = __ldg(ptr + row);
  int end = __ldg(ptr + row + 1);
  float acc = 0.0f;
  for (int e0 = first; e0 < last; e0 += kGroup) {
    float v[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int e = e0 + u;
      v[u] = 0.0f;
      if (e < last) {
        float xv[1];
        runs::ldg_vec<1>(x + (kIdentity ? e : __ldg(col + e)), xv);
        v[u] = kWeighted ? __ldg(w + e) * xv[0] : xv[0];
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int e = e0 + u;
      if (e < last) {
        while (e >= end) {
          *piece_dst(out, head, tail, row, begin, end, first, last, k, 1) =
              acc;
          acc = 0.0f;
          ++row;
          begin = end;
          end = __ldg(ptr + row + 1);
        }
        acc += v[u];
      }
    }
  }
  *piece_dst(out, head, tail, row, begin, end, first, last, k, 1) = acc;
  cross[k] = runs::cross_code(row, begin, end, first, last);
  if (last == n_edges) {
    for (int r = row + 1; r < n_rows; ++r) out[r] = 0.0f;
  }
}

// The grids of one CSR sum: the runs, then the fix-up of the rows that
// cross runs; ws holds the runs' head [n_runs, d] | tail [n_runs, d] |
// cross [n_runs] (int32), then the same for the fix-up's chunks.
template <bool kWeighted, bool kIdentity, typename T>
int launch_runs(const int* ptr, const int* col, const float* w, const T* x,
                float* out, float* ws, int n_rows, int n_slots, int run,
                int d, cudaStream_t stream) {
  const int64_t n_runs = runs::count(n_slots, run);
  float* head = ws;
  float* tail = ws + n_runs * d;
  int* cross = reinterpret_cast<int*>(ws + 2 * n_runs * d);
  if (d == 1) {
    const int64_t blocks = (n_runs + kD1Threads - 1) / kD1Threads;
    csr_spmm_runs_d1_kernel<kWeighted, kIdentity, T>
        <<<static_cast<unsigned>(blocks), kD1Threads, 0, stream>>>(
            ptr, col, w, x, out, head, tail, cross, n_rows, run);
  } else {
    const uintptr_t at = runs::float_at(x);
    const int64_t blocks = (n_runs + kWarpsPerBlock - 1) / kWarpsPerBlock;
    const unsigned grid = static_cast<unsigned>(blocks);
    const int threads = kWarpsPerBlock * kWarp;
    if (d >= 128 && d % 4 == 0 && at % 16 == 0) {
      csr_spmm_runs_kernel<4, kWeighted, kIdentity, T>
          <<<grid, threads, 0, stream>>>(ptr, col, w, x, out, head, tail,
                                         cross, n_rows, run, d);
    } else if (d >= 64 && d % 2 == 0 && at % 8 == 0) {
      csr_spmm_runs_kernel<2, kWeighted, kIdentity, T>
          <<<grid, threads, 0, stream>>>(ptr, col, w, x, out, head, tail,
                                         cross, n_rows, run, d);
    } else {
      csr_spmm_runs_kernel<1, kWeighted, kIdentity, T>
          <<<grid, threads, 0, stream>>>(ptr, col, w, x, out, head, tail,
                                         cross, n_rows, run, d);
    }
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return runs::fixup(ptr, ws, out, n_rows, n_runs, run, d, stream);
}

}  // namespace

// Every entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after its launch (0 = launched), so a refused launch
// is reported.

// Both sums take ws [(n_runs + n_chunks) (2 d + 1)] float32 with n_runs =
// max(1, ceil(n_slots / run)) and n_chunks = ceil(n_runs /
// csr_fix_chunk_runs(d)): n_slots >= ptr[n_rows] bounds the slots (the
// number of edges itself is read from ptr on the card), run >= 1 is the
// run length in slots.  Up to three grids: the runs, then the fix-up of the
// rows that cross runs (runs.cuh: level 1, and level 2 where there is more
// than one chunk).  Every row of out is written.

namespace {

template <typename T>
int csr_spmm(const int* ptr, const int* col, const float* w, const T* x,
             float* out, float* ws, int n_rows, int n_slots, int run, int d,
             cudaStream_t stream) {
  if (n_rows <= 0 || d <= 0 || n_slots < 0 || run < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (w != nullptr) {
    return launch_runs<true, false, T>(ptr, col, w, x, out, ws, n_rows,
                                       n_slots, run, d, stream);
  }
  return launch_runs<false, false, T>(ptr, col, w, x, out, ws, n_rows,
                                      n_slots, run, d, stream);
}

}  // namespace

// out[r] = sum_{e in row r} w[e] x[col[e]]; a null `w` means unit weights.
extern "C" int csr_spmm_f32(const int* ptr, const int* col, const float* w,
                            const float* x, float* out, float* ws, int n_rows,
                            int n_slots, int run, int d, cudaStream_t stream) {
  return csr_spmm<float>(ptr, col, w, x, out, ws, n_rows, n_slots, run, d,
                         stream);
}

// The same over x [n_cols, d] stored in bfloat16; out float32.
extern "C" int csr_spmm_bf16(const int* ptr, const int* col, const float* w,
                             const __nv_bfloat16* x, float* out, float* ws,
                             int n_rows, int n_slots, int run, int d,
                             cudaStream_t stream) {
  return csr_spmm<__nv_bfloat16>(ptr, col, w, x, out, ws, n_rows, n_slots,
                                 run, d, stream);
}

// out[r] = sum of values' rows [ptr[r], ptr[r+1]); values [>= ptr[n_rows],
// d].
extern "C" int seg_reduce_f32(const int* ptr, const float* values,
                              float* out, float* ws, int n_rows, int n_slots,
                              int run, int d, cudaStream_t stream) {
  if (n_rows <= 0 || d <= 0 || n_slots < 0 || run < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_runs<false, true, float>(ptr, nullptr, nullptr, values, out,
                                         ws, n_rows, n_slots, run, d, stream);
}

// dx [n_rows, d] and dw [n_slots] (n_slots >= ptr[n_rows], the slots past
// it 0) of a weighted SpMM's backward: g [n_cols, d] gathered by col, x
// [n_rows, d] the rows' own, w [> max id] read at id_e = eid[e] (e when eid
// is null); ws as the sums above take it; `group` the lanes an edge, 8, 16
// or 32.  The runs' grid, then the fix-up of the rows of dx that cross
// runs.  d = 0 is a shape (dw = 0).
extern "C" int csr_spmm_dw_f32(const int* ptr, const int* col, const int* eid,
                               const float* w, const float* g, const float* x,
                               float* dx, float* dw, float* ws, int n_rows,
                               int n_slots, int run, int group, int d,
                               cudaStream_t stream) {
  gat_bwd::Args args{};
  args.eid = eid;
  args.w = w;
  args.o1 = dw;
  args.sums = dx;
  args.ws = ws;
  return gat_bwd::launch<gat_bwd::Src::kDw>(ptr, col, x, g, args, n_rows,
                                            n_slots, run, group, d,
                                            kDwWarps, stream);
}

// The same with g [n_cols, d] and x [n_rows, d] stored in bfloat16; w, dx,
// dw and ws float32.
extern "C" int csr_spmm_dw_bf16(const int* ptr, const int* col,
                                const int* eid, const float* w,
                                const __nv_bfloat16* g,
                                const __nv_bfloat16* x, float* dx, float* dw,
                                float* ws, int n_rows, int n_slots, int run,
                                int group, int d, cudaStream_t stream) {
  gat_bwd::Args args{};
  args.eid = eid;
  args.w = w;
  args.o1 = dw;
  args.sums = dx;
  args.ws = ws;
  return gat_bwd::launch<gat_bwd::Src::kDw>(ptr, col, x, g, args, n_rows,
                                            n_slots, run, group, d,
                                            kDwWarps, stream);
}

// Runs a chunk of the fix-up's first level at width d (the workspace's
// n_chunks above).
extern "C" int csr_fix_chunk_runs(int d) { return runs::chunk_runs(d); }

extern "C" const char* csr_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
