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
// d floats is a few coalesced loads of a group of lanes, and an [n, 64]
// operand of 1 MB stays in L2, so neither the one-hot selects nor the hub
// table carry over.
// The sums are plain float32.
//
// It is the weight gradient of the weighted SpMM (dw[e] = <g[row], x[col]>)
// and the forward of SddmmOperator.
//
// Bound: bytes.  Each edge needs its column index and its output (8 B);
// the rows of a and b are read once (4 n d B each) and the pointer once;
// 2 E d flops are far below the card's float32 rate.
//
// Design: the per-edge walk of gat_bwd.cuh with no softmax (the source
// kNone), which flash_bwd_f32 and r1_bwd_f32 share.  A warp takes a run of
// `run` consecutive slots of [0, n_out), so a row of any length is spread
// over as many warps as it has runs and the 3,842-edge row of the linkpred
// graph sets no tail; it finds its first row by a warp-wide search of ptr
// (3 dependent loads at 4,267 rows).  The warp is split into groups of G
// lanes (8, 16 or 32), one edge a group: for each row piece the lanes hold
// a[r] in registers, each edge's b row is one G-lane load of float4s where
// both operands are aligned, a log2(G)-round shuffle sums the group, and
// one lane stores out[e].  Every output is one group's sum in a fixed
// order: deterministic, no atomics.  The run's pad slots past ptr[n_rows]
// are written as 0 by the same grid; nothing sums over a row, so there is
// no second grid.

#include <cuda_runtime.h>

#include <cstdint>

#include "gat_bwd.cuh"

// Launches on `stream`; does not synchronise.  ptr [n_rows + 1] and col
// [>= ptr[n_rows]] int32 (the edge count is read from ptr on the card), a
// [n_rows, d] and b [n_cols, d] float32 row-major, d >= 1, out [n_out]
// float32 with n_out >= ptr[n_rows]; `run` slots a warp, `group` the lanes
// an edge (8, 16 or 32).  Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int csr_sddmm_f32(const int* ptr, const int* col, const float* a,
                             const float* b, float* out, int n_rows,
                             int n_out, int run, int group, int d,
                             cudaStream_t stream) {
  if (d <= 0 || n_out < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_out == 0) return 0;
  gat_bwd::Args args{};
  args.o1 = out;
  return gat_bwd::launch<gat_bwd::Src::kNone>(ptr, col, a, b, args, n_rows,
                                              n_out, run, group, d,
                                              gat_bwd::kMaxWarps, stream);
}

extern "C" const char* csr_sddmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
