// csr_spmm_f32: sparse (CSR) times dense, in float32.
//
//   out[r, :] = sum_{e = ptr[r]}^{ptr[r+1]-1} w[e] * x[col[e], :]
//
// with w[e] = 1 when w is null (an unweighted reduce reads no weights).
//
// Replaces two TPU kernels of msha_gnn_tpu/ops/pallas/spmm.py, which
// compute this same function:
//   * _visit_kernel: a one-hot MXU reduce of CSR edge chunks into 128-row
//     output blocks, walked by a host-built chunk-visit schedule;
//   * _hub_kernel: the same reduce for edges whose column is one of the
//     top-H columns, served from an [H, d] table composed on the MXU.
// Both schedules answer TPU limits: a row gather that is issue-bound and a
// matrix unit that wants 128-row blocks.  On Hopper a gathered row of
// d = 32 floats is one coalesced 128-byte load per warp, and a small x
// (the [32, 32] operand of the GCN's second layer) stays in L1/L2, so one
// CSR kernel serves both.
//
// Bound: bytes.  Each edge needs its column index and weight (8 B, or 4 B
// unweighted) and one row of x; the operations (2 * E * d flops) are far
// below the card's rate.
// At the GCN's shapes each call moves about 6 MB at minimum, about 2 us at
// HBM rate, so the launch and the per-row latency chain dominate.
//
// Design (simple and right first): one block per output row.  The block's
// warps stride over the row's edges, each lane owns one feature of a
// 32-wide feature tile, and the warps' partial sums are added in shared
// memory in a fixed order.  No atomics: the result is deterministic.  The
// caller picks the warps per block (1..8) from the mean row length.
// Splitting very long rows over several blocks is left for later.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;

template <bool kWeighted>
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
        const int64_t src = static_cast<int64_t>(__ldg(col + e));
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

}  // namespace

// Launches on `stream`; does not synchronise.  A null `w` means unit
// weights.  Returns cudaGetLastError()
// after the launch (0 = launched), so a refused launch is reported.
extern "C" int csr_spmm_f32(const int* ptr, const int* col, const float* w,
                            const float* x, float* out, int n_rows, int d,
                            int n_warps, cudaStream_t stream) {
  if (n_rows <= 0 || d <= 0 || n_warps < 1 || n_warps > kMaxWarps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (w != nullptr) {
    csr_spmm_f32_kernel<true><<<n_rows, n_warps * kWarp, 0, stream>>>(
        ptr, col, w, x, out, d);
  } else {
    csr_spmm_f32_kernel<false><<<n_rows, n_warps * kWarp, 0, stream>>>(
        ptr, col, w, x, out, d);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* csr_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
