// csr_sddmm_f32: sampled dense-dense product over a CSR edge list, in
// float32.
//
//   out[e] = <a[row(e), :], b[col[e], :]>   for e < n_edges = ptr[n_rows]
//   out[e] = 0                              for n_edges <= e < n_out (pads)
//
// with row(e) the row whose range [ptr[r], ptr[r+1]) holds e.
//
// Replaces two TPU kernels of msha_gnn_tpu/ops/pallas/spmm.py, which
// compute this same function in CSR edge order:
//   * _sddmm_kernel: the sorted (row) side gathered by a transposed one-hot
//     product on the MXU over 128-row blocks, through a bf16 hi/lo split,
//     and the column side by an XLA row gather;
//   * _sddmm_hub_kernel: the same, with the column rows of the top-H
//     columns composed from an [H, d] table in VMEM.
// Both answer v5e's issue-bound row gather.  On Hopper a gathered row of
// d floats is d / 32 coalesced warp loads, and an [n, 64] operand of 1 MB
// stays in L2, so neither the one-hot selects nor the hub table carry over.
// The sums are plain float32.
//
// It is the weight gradient of the weighted SpMM (dw[e] = <g[row], x[col]>)
// and the forward of SddmmOperator.
//
// Bound: bytes.  Each edge needs its column index and its output (8 B);
// the rows of a and b are read once (4 n d B each) and the pointer once;
// 2 E d flops are far below the card's float32 rate.
//
// Design (simple and right first).  Edges go to warps in fixed chunks of
// kChunk consecutive CSR slots, so a row of any length is spread over as
// many warps as it has chunks and the 3,842-edge row of the linkpred graph
// sets no tail.  A warp finds its chunk's first row by a binary search of
// ptr, then walks its edges in groups of kUnroll, advancing the row as the
// slots pass ptr[row + 1].  Lanes run over the feature dimension; each
// edge's b row is one coalesced load per 32 features, a's row comes from
// L1 (consecutive edges of a row share it), and a shuffle tree sums the
// lanes.  Every output is one warp's sum in a fixed order: deterministic,
// no atomics.  Pad slots past n_edges are written as 0 by the same grid.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kChunk = 64;    // CSR slots per warp
constexpr int kUnroll = 4;    // edges whose loads are in flight together
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o /= 2) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The last row r in [0, n_rows) with ptr[r] <= e (empty rows before a
// non-empty one share its start, and the search lands on the non-empty one).
__device__ __forceinline__ int row_of(const int* __restrict__ ptr, int n_rows,
                                      int e) {
  int lo = 0;
  int hi = n_rows;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (__ldg(ptr + mid) <= e) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
csr_sddmm_f32_kernel(const int* __restrict__ ptr, const int* __restrict__ col,
                     const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ out, int n_rows, int n_edges,
                     int n_out, int d) {
  const int lane = threadIdx.x % kWarp;
  const int64_t warp_id = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                          threadIdx.x / kWarp;
  const int64_t first = warp_id * kChunk;
  if (first >= n_out) return;
  const int last = static_cast<int>(
      first + kChunk < n_out ? first + kChunk : static_cast<int64_t>(n_out));
  int row = first < n_edges ? row_of(ptr, n_rows, static_cast<int>(first)) : 0;
  for (int e0 = static_cast<int>(first); e0 < last; e0 += kUnroll) {
    int64_t arow[kUnroll];
    int64_t brow[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = e0 + u;
      if (e < last && e < n_edges) {
        while (__ldg(ptr + row + 1) <= e) ++row;
        arow[u] = static_cast<int64_t>(row) * d;
        brow[u] = static_cast<int64_t>(__ldg(col + e)) * d;
      } else {
        arow[u] = -1;
        brow[u] = -1;
      }
    }
    float acc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc[u] = 0.0f;
    for (int f = lane; f < d; f += kWarp) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (brow[u] >= 0) {
          acc[u] = fmaf(__ldg(a + arow[u] + f), __ldg(b + brow[u] + f),
                        acc[u]);
        }
      }
    }
    float mine = 0.0f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float s = warp_sum(acc[u]);
      if (lane == u) mine = s;
    }
    if (lane < kUnroll && e0 + lane < last) out[e0 + lane] = mine;
  }
}

}  // namespace

// Launches on `stream`; does not synchronise.  ptr [n_rows + 1] and col
// [n_edges] int32 (n_edges = ptr[n_rows]), a [n_rows, d] and b [n_cols, d]
// float32 row-major, out [n_out] float32 with n_out >= n_edges.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int csr_sddmm_f32(const int* ptr, const int* col, const float* a,
                             const float* b, float* out, int n_rows,
                             int n_edges, int n_out, int d,
                             cudaStream_t stream) {
  if (n_rows <= 0 || d <= 0 || n_edges < 0 || n_out < n_edges) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_out == 0) return 0;
  const int64_t warps = (static_cast<int64_t>(n_out) + kChunk - 1) / kChunk;
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  csr_sddmm_f32_kernel<<<static_cast<unsigned>(blocks),
                         kWarpsPerBlock * kWarp, 0, stream>>>(
      ptr, col, a, b, out, n_rows, n_edges, n_out, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* csr_sddmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
