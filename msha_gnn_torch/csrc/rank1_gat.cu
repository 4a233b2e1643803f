// The rank-1 GAT kernels: the fused layer with a destination-linear logit
// (the forward r1l_fwd_f32 and its recompute backward r1l_bwd_f32, and
// their bfloat16 payloads r1l_fwd_bf16 and r1l_bwd_bf16) and the generic
// form's forward r1_fwd_f32 and its bfloat16 payload r1_fwd_bf16 (its
// backward, r1_bwd_f32 / r1_bwd_bf16, is in flash_gat.cu).
//
// For a CSR graph (row r has edges e in [ptr[r], ptr[r+1]), j = col[e]):
//
//   t_e   = <x[j], a>        (r1l: computed here, per edge; r1: t[j], given)
//   pre_e = c[r] + t_e,   l_e = leaky(pre_e, slope)
//   p_e   = exp(l_e - max_row l)           (softmax stats over UNdropped p)
//   k_e   = keep scale of slot e: 1/(1-rate) if kept, 0 if dropped, 1 at rate 0
//   out[r] = sum_e p_e k_e x[j] / sum_e p_e,   lse[r] = max + log(sum p)
//
// An empty row gets out = 0 and lse = NEG (-1e30).  The generic form has no
// dropout.
//
// Replaces three TPU kernels of msha_gnn_tpu/ops/pallas/rank1_gat.py:
//   * _r1l_fwd_kernel (forward, above);
//   * _r1_fwd_kernel, the generic forward, whose t rides the row gather as
//     an extra column;
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
// Bound: bytes at the linkpred shapes.  Forward: the CSR arrays, c, x (and
// t) and out (a few MB, x staying in L2) against 2 E d flops; its
// workspace of crossing-row pieces (about 1.4 MB at d 64) is the
// schedule's, not the function's.  Backward: the CSR arrays, c, x, gout,
// out and lse in, q and dpre (8 B an edge), dc and da out, about 6 MB;
// 7 E d flops, a few us at the float32 rate.
//
// Forward (both forms): the edge-run walk of gat_fwd.cuh, a warp per run
// of `run` consecutive CSR slots split into groups of G lanes, one edge a
// group, each group an online softmax in registers, and a second grid
// that merges the rows crossing runs in run order.  The logit source is
// kDot for r1l_fwd_f32 (<x[j], a> a group dot of the x[j] the group holds
// anyway, a log2(G)-round shuffle sum) and kRank1 for r1_fwd_f32 (t[j],
// one gather beside the row of x).
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
//
// The bfloat16 payload (r1l_fwd_bf16, r1l_bwd_bf16, r1_fwd_bf16; the TPU
// kernels' mode without the lo pass, rank1_gat.py:149-151, :294-296; the
// generic form's t is rounded to bfloat16 by the caller): x is stored and
// streamed in bfloat16, at half its bytes, and every other input, output
// and quantity is float32: t_e = <x[j], a>, the logits, the softmax, the
// aggregation, q, dpre, dc and da come from the bfloat16 rows widened in
// registers (the row type is a template parameter of both walks).  The
// TPU kernels also round the unnormalised p to bfloat16 before the MXU
// product; that is their schedule's, and here p stays float32.  The keep
// mask's hash is the same.

#include <cuda_runtime.h>

#include <cstdint>

#include "gat_common.cuh"
#include "gat_fwd.cuh"
#include "runs.cuh"

namespace {

using gat::keep_scale;
using gat::kNeg;
using gat::kWarp;
using gat::leaky;
using gat::warp_sum;

constexpr int kMaxWarps = 8;
constexpr int kEdges = 4;   // r1l_bwd_f32: edges whose rows are in flight

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
// Lanes hold kVec consecutive features of each 32 kVec-wide tile.  T: the
// type of x's rows (float or __nv_bfloat16).
template <int kVec, bool kDrop, typename T>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
r1l_bwd_kernel(const int* __restrict__ ptr, const int* __restrict__ col,
               const float* __restrict__ c, const float* __restrict__ a,
               const T* __restrict__ x, const float* __restrict__ gout,
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
    runs::add_crossing(ptr, dc_head, dc_tail, cross, dc, n_rows, run, k);
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

size_t bwd_smem(int d, int n_warps) {
  return sizeof(float) * static_cast<size_t>(d) * (1 + n_warps);
}

constexpr size_t kMaxSmem = 48 * 1024;

// d = 0 is a shape: the logits are c[r] and dc does not vanish.
bool bad_shape(int n_rows, int d, int n_warps) {
  return n_rows <= 0 || d < 0 || n_warps < 1 || n_warps > kMaxWarps;
}

template <typename T>
int r1l_bwd(const int* ptr, const int* col, const float* c, const float* a,
            const T* x, const float* gout, const float* out,
            const float* lse, const int* seed, float rate, float scale,
            float slope, float* q, float* dpre, float* dc, float* ws,
            float* da, int n_rows, int n_slots, int run, int d, int n_warps,
            cudaStream_t stream) {
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
  const uintptr_t at = runs::float_at(x) |
                       reinterpret_cast<uintptr_t>(gout);
  const int vec = (d >= 128 && d % 4 == 0 && at % 16 == 0)  ? 4
                  : (d >= 64 && d % 2 == 0 && at % 8 == 0) ? 2
                                                            : 1;
  const bool drop = rate > 0.0f;
  auto kernel = drop ? (vec == 4   ? r1l_bwd_kernel<4, true, T>
                        : vec == 2 ? r1l_bwd_kernel<2, true, T>
                                   : r1l_bwd_kernel<1, true, T>)
                     : (vec == 4   ? r1l_bwd_kernel<4, false, T>
                        : vec == 2 ? r1l_bwd_kernel<2, false, T>
                                   : r1l_bwd_kernel<1, false, T>);
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

}  // namespace

// All entry points launch on `stream`, do not synchronise, and return
// cudaGetLastError() after their launches (0 = launched).  `seed` is a
// device pointer to one int32, read only when rate > 0.  `scale` is the
// kept edges' factor 1/(1-rate), given by the caller in float32.

// Two grids (gat_fwd.cuh): the runs (rows inside a run, head and tail
// pieces of the others), then the crossing rows' pieces merged in run
// order.  col [n_slots] in CSR order, n_slots >= ptr[n_rows] (the edge
// count is read from ptr on the card); c [n_rows], a [d], x [n_cols, d];
// out [n_rows, d], lse [n_rows]; ws [n_runs (2 d + 5)] float32 with n_runs
// = max(1, ceil(n_slots / run)); group the lanes an edge, 8, 16 or 32.
extern "C" int r1l_fwd_f32(const int* ptr, const int* col, const float* c,
                           const float* a, const float* x, const int* seed,
                           float rate, float scale, float slope, float* out,
                           float* lse, float* ws, int n_rows, int n_slots,
                           int run, int group, int d, int n_warps,
                           cudaStream_t stream) {
  const gat_fwd::LogitArgs args{nullptr, c, a, nullptr, slope};
  return gat_fwd::launch<gat_fwd::Logit::kDot>(
      ptr, col, args, x, seed, rate, scale, out, lse, ws, n_rows, n_slots,
      run, group, d, n_warps, stream);
}

// The same over x [n_cols, d] stored in bfloat16.
extern "C" int r1l_fwd_bf16(const int* ptr, const int* col, const float* c,
                            const float* a, const __nv_bfloat16* x,
                            const int* seed, float rate, float scale,
                            float slope, float* out, float* lse, float* ws,
                            int n_rows, int n_slots, int run, int group,
                            int d, int n_warps, cudaStream_t stream) {
  const gat_fwd::LogitArgs args{nullptr, c, a, nullptr, slope};
  return gat_fwd::launch<gat_fwd::Logit::kDot>(
      ptr, col, args, x, seed, rate, scale, out, lse, ws, n_rows, n_slots,
      run, group, d, n_warps, stream);
}

// The generic forward, the same two grids on the logits leaky(c[r] +
// t[col_e]); c [n_rows], t [n_cols], x [n_cols, d]; the rest as
// r1l_fwd_f32's, without dropout.
extern "C" int r1_fwd_f32(const int* ptr, const int* col, const float* c,
                          const float* t, const float* x, float slope,
                          float* out, float* lse, float* ws, int n_rows,
                          int n_slots, int run, int group, int d, int n_warps,
                          cudaStream_t stream) {
  const gat_fwd::LogitArgs args{nullptr, c, nullptr, t, slope};
  return gat_fwd::launch<gat_fwd::Logit::kRank1>(
      ptr, col, args, x, nullptr, 0.0f, 1.0f, out, lse, ws, n_rows, n_slots,
      run, group, d, n_warps, stream);
}

// The generic forward over x [n_cols, d] stored in bfloat16 (the TPU
// kernel's bf16 mode, lo_pass=False, rank1_gat.py:149-151): the rows
// widened in registers; t [n_cols] float32 as the caller gives it (the
// operator rounds it to bfloat16 first, as the TPU operator casts its
// [x || t] rows, :586-592); every other quantity float32.
extern "C" int r1_fwd_bf16(const int* ptr, const int* col, const float* c,
                           const float* t, const __nv_bfloat16* x,
                           float slope, float* out, float* lse, float* ws,
                           int n_rows, int n_slots, int run, int group, int d,
                           int n_warps, cudaStream_t stream) {
  const gat_fwd::LogitArgs args{nullptr, c, nullptr, t, slope};
  return gat_fwd::launch<gat_fwd::Logit::kRank1>(
      ptr, col, args, x, nullptr, 0.0f, 1.0f, out, lse, ws, n_rows, n_slots,
      run, group, d, n_warps, stream);
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
  return r1l_bwd<float>(ptr, col, c, a, x, gout, out, lse, seed, rate, scale,
                        slope, q, dpre, dc, ws, da, n_rows, n_slots, run, d,
                        n_warps, stream);
}

// The same over x [n_cols, d] stored in bfloat16; everything else float32.
extern "C" int r1l_bwd_bf16(const int* ptr, const int* col, const float* c,
                            const float* a, const __nv_bfloat16* x,
                            const float* gout, const float* out,
                            const float* lse, const int* seed, float rate,
                            float scale, float slope, float* q, float* dpre,
                            float* dc, float* ws, float* da, int n_rows,
                            int n_slots, int run, int d, int n_warps,
                            cudaStream_t stream) {
  return r1l_bwd<__nv_bfloat16>(ptr, col, c, a, x, gout, out, lse, seed,
                                rate, scale, slope, q, dpre, dc, ws, da,
                                n_rows, n_slots, run, d, n_warps, stream);
}

// The largest warps per block (1..8) for the kernels at feature width d:
// the forwards take any (they keep no shared memory), r1l_bwd_f32 as many
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
