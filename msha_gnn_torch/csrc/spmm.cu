// CSR walks in float32, one block per output row:
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
// with the slots [ptr[n_rows], n_dw) of dw zeroed.  For A @ x the caller
// walks the CSC (eid = the CSC -> CSR edge map, so dw lands in CSR order
// and each slot is written once); for A.T @ x it walks the CSR (eid null).
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
// csr_spmm_dw_f32 adds eid and the dw write, 8 B); the operations (2 E d
// flops, 4 E d with dw) are far below the card's rate.  At the GCN's
// shapes each call moves about 6 MB at minimum, about 2 us at HBM rate, so
// the launch and the per-row latency chain dominate.
//
// Design (simple and right first): one block per output row.  The block's
// warps stride over the row's edges, each lane owns one feature of a
// 32-wide feature tile, and the warps' partial sums are added in shared
// memory in a fixed order.  No atomics: the result is deterministic.  The
// caller picks the warps per block (1..8) from the row lengths.
// csr_spmm_dw_f32 holds x[r] in shared memory for the whole row; each warp
// takes groups of kUnroll edges, forms the group's dots with x[r] (one warp
// sum each) while it accumulates w g into its own row of shared memory.
// Splitting very long rows over several blocks is left for later.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmem = 48 * 1024;

// kIdentity: the edge's own index is its row of x (col is not read).
template <bool kWeighted, bool kIdentity>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
csr_spmm_f32_kernel(const int* __restrict__ ptr, const int* __restrict__ col,
                    const float* __restrict__ w, const float* __restrict__ x,
                    float* __restrict__ out, int d) {
  __shared__ float partial[kMaxWarps][kWarp];
  const int row = blockIdx.x;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int n_warps = blockDim.x / kWarp;
  const int begin = ptr[row];
  const int end = ptr[row + 1];
  for (int f0 = 0; f0 < d; f0 += kWarp) {
    const int f = f0 + lane;
    float acc = 0.0f;
    if (f < d) {
#pragma unroll 4
      for (int e = begin + warp; e < end; e += n_warps) {
        const int64_t src = kIdentity ? static_cast<int64_t>(e)
                                      : static_cast<int64_t>(__ldg(col + e));
        const float v = __ldg(x + src * d + f);
        acc = kWeighted ? fmaf(__ldg(w + e), v, acc) : acc + v;
      }
    }
    partial[warp][lane] = acc;
    __syncthreads();
    if (warp == 0 && f < d) {
      float sum = partial[0][lane];
      for (int k = 1; k < n_warps; ++k) sum += partial[k][lane];
      out[static_cast<int64_t>(row) * d + f] = sum;
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Dynamic shared memory: x[r] (d) | acc[n_warps][d].  One block per row
// (gridDim.x = n_rows); the same grid zeroes dw's slots [ptr[n_rows], n_dw).
template <bool kEid>
__global__ void __launch_bounds__(kMaxWarps * kWarp)
csr_spmm_dw_f32_kernel(const int* __restrict__ ptr,
                       const int* __restrict__ col,
                       const int* __restrict__ eid,
                       const float* __restrict__ w,
                       const float* __restrict__ g,
                       const float* __restrict__ x, float* __restrict__ dx,
                       float* __restrict__ dw, int n_dw, int d) {
  extern __shared__ float smem[];
  const int n_warps = blockDim.x / kWarp;
  float* x_s = smem;
  float* acc_all = x_s + d;
  const int row = blockIdx.x;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int64_t row_off = static_cast<int64_t>(row) * d;
  float* acc = acc_all + warp * d;
  for (int f = threadIdx.x; f < d; f += blockDim.x) x_s[f] = x[row_off + f];
  for (int f = lane; f < d; f += kWarp) acc[f] = 0.0f;
  const int n_edges = ptr[gridDim.x];
  for (int64_t i = n_edges + static_cast<int64_t>(row) * blockDim.x +
                   threadIdx.x;
       i < n_dw; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    dw[i] = 0.0f;
  }
  __syncthreads();

  const int begin = ptr[row];
  const int end = ptr[row + 1];
  for (int e0 = begin + warp * kUnroll; e0 < end;
       e0 += n_warps * kUnroll) {
    int64_t grow[kUnroll];
    int id[kUnroll];
    float we[kUnroll];
    float dot[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u;
      const bool ok = e < end;
      grow[u] = ok ? static_cast<int64_t>(__ldg(col + e)) * d : -1;
      id[u] = ok ? (kEid ? __ldg(eid + e) : e) : 0;
      we[u] = ok ? __ldg(w + id[u]) : 0.0f;
      dot[u] = 0.0f;
    }
    for (int f = lane; f < d; f += kWarp) {
      const float xf = x_s[f];
      float v = acc[f];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (grow[u] >= 0) {
          const float gv = __ldg(g + grow[u] + f);
          dot[u] = fmaf(gv, xf, dot[u]);
          v = fmaf(we[u], gv, v);
        }
      }
      acc[f] = v;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      dot[u] = warp_sum(dot[u]);
      if (lane == u && grow[u] >= 0) dw[id[u]] = dot[u];
    }
  }
  __syncthreads();
  for (int f = threadIdx.x; f < d; f += blockDim.x) {
    float v = 0.0f;
    for (int k = 0; k < n_warps; ++k) v += acc_all[k * d + f];
    dx[row_off + f] = v;
  }
}

size_t dw_smem(int d, int n_warps) {
  return sizeof(float) * static_cast<size_t>(d) * (1 + n_warps);
}

}  // namespace

// Every entry point launches on `stream`, does not synchronise, and returns
// cudaGetLastError() after its launch (0 = launched), so a refused launch
// is reported.

// A null `w` means unit weights.
extern "C" int csr_spmm_f32(const int* ptr, const int* col, const float* w,
                            const float* x, float* out, int n_rows, int d,
                            int n_warps, cudaStream_t stream) {
  if (n_rows <= 0 || d <= 0 || n_warps < 1 || n_warps > kMaxWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (w != nullptr) {
    csr_spmm_f32_kernel<true, false>
        <<<n_rows, n_warps * kWarp, 0, stream>>>(ptr, col, w, x, out, d);
  } else {
    csr_spmm_f32_kernel<false, false>
        <<<n_rows, n_warps * kWarp, 0, stream>>>(ptr, col, w, x, out, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// out[r] = sum of values' rows [ptr[r], ptr[r+1]); values [>= ptr[n_rows],
// d].
extern "C" int seg_reduce_f32(const int* ptr, const float* values,
                              float* out, int n_rows, int d, int n_warps,
                              cudaStream_t stream) {
  if (n_rows <= 0 || d <= 0 || n_warps < 1 || n_warps > kMaxWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  csr_spmm_f32_kernel<false, true><<<n_rows, n_warps * kWarp, 0, stream>>>(
      ptr, nullptr, nullptr, values, out, d);
  return static_cast<int>(cudaGetLastError());
}

// dx [n_rows, d] and dw [n_dw] (n_dw >= ptr[n_rows], the slots past it 0)
// of a weighted SpMM's backward: g [n_cols, d] gathered by col, x [n_rows,
// d] the rows' own, w [> max id] read at id_e = eid[e] (e when eid is
// null).  d = 0 is a shape (dw = 0).
extern "C" int csr_spmm_dw_f32(const int* ptr, const int* col, const int* eid,
                               const float* w, const float* g, const float* x,
                               float* dx, float* dw, int n_rows, int n_dw,
                               int d, int n_warps, cudaStream_t stream) {
  if (n_rows <= 0 || d < 0 || n_dw < 0 || n_warps < 1 ||
      n_warps > kMaxWarps || dw_smem(d, n_warps) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = dw_smem(d, n_warps);
  if (eid != nullptr) {
    csr_spmm_dw_f32_kernel<true><<<n_rows, n_warps * kWarp, smem, stream>>>(
        ptr, col, eid, w, g, x, dx, dw, n_dw, d);
  } else {
    csr_spmm_dw_f32_kernel<false><<<n_rows, n_warps * kWarp, smem, stream>>>(
        ptr, col, eid, w, g, x, dx, dw, n_dw, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// The most warps per block (1..8) whose shared memory fits
// csr_spmm_dw_f32 at feature width d; 0 when even one warp does not fit.
extern "C" int csr_spmm_dw_max_warps(int d) {
  for (int w = kMaxWarps; w >= 1; --w) {
    if (dw_smem(d, w) <= kMaxSmem) return w;
  }
  return 0;
}

extern "C" const char* csr_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
