// Flash-GAT in float32: the softmax of given per-edge logits over each CSR
// row, the hashed attention dropout and the aggregation in one pass
// (flash_fwd_f32), and its recompute backward (flash_bwd_f32); and the
// generic rank-1 GAT's backward (r1_bwd_f32, and r1_bwd_bf16 over
// bfloat16 rows; its forward, r1_fwd_f32 / r1_fwd_bf16, is in
// rank1_gat.cu).
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
// dl's place), and dc[r] = sum_{e in r} dpre_e, summed by row piece and
// across runs in a fixed order; the caller takes dx = the att-weighted
// transposed csr_spmm_f32 of gout and dt[j] = sum_{e: col_e = j} dpre_e.
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
//     reduces that read them.  Its bfloat16 mode (the TPU kernel's xt in
//     bfloat16, rank1_gat.py:586-592) is r1_bwd_bf16: x stored in
//     bfloat16 and widened in registers, t rounded to bfloat16 by the
//     caller, gout, out, lse and every sum float32, as the TPU kernel keeps
//     gout (hi/lo) and z.
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
// flash_bwd_f32 and r1_bwd_f32: the per-edge walk of gat_bwd.cuh, with
// the logits read (kRead) or formed from c[r] + t[j] (kRank1): a warp per
// run of `run` consecutive CSR slots (a long row spread over as many warps
// as it has runs), split into groups of G lanes (8, 16 or 32), one edge a
// group.  For each row piece the warp holds gout[r] in registers (d / G
// floats a lane) and forms <gout[r], out[r]> and lse[r] once; a group's dot
// <gout[r], x[j]> is a float4-wide multiply-add a lane and a log2(G)-round
// shuffle sum, and one lane of the group does the edge's scalar work and
// its two stores.  The same grid zeroes the pads.  flash_bwd_f32 sums
// nothing over a row and has one grid; r1_bwd_f32's dc is summed by row
// piece, and the fix-up grids of runs.cuh add the rows that cross runs.
//
// No float atomics, so results are deterministic.

#include <cuda_runtime.h>

#include <cstdint>

#include "gat_bwd.cuh"
#include "gat_common.cuh"
#include "gat_fwd.cuh"

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
  gat_bwd::Args args{};
  args.logits = logits;
  args.out = out;
  args.lse = lse;
  args.seed = seed;
  args.rate = rate;
  args.scale = scale;
  args.o1 = dl;
  args.o2 = q;
  return gat_bwd::launch<gat_bwd::Src::kRead>(ptr, col, gout, x, args,
                                              n_rows, n_out, run, group, d,
                                              n_warps, stream);
}

// The generic rank-1 GAT backward: the runs (att, dpre, the dc of the rows
// inside a run and the crossing rows' pieces), then the crossing rows' dc
// added by the fix-up grids (runs.cuh).  att and dpre [n_out] (n_out >=
// ptr[n_rows], the pads 0), dc [n_rows]; gout, out [n_rows, d] and lse
// [n_rows] as r1_fwd_f32 gave them; ws float32 as gat_bwd::launch sizes
// it at width 1 (spmm.py's sums_ws_floats(n_out, run, 1)); group the
// lanes an edge, 8, 16 or 32.
extern "C" int r1_bwd_f32(const int* ptr, const int* col, const float* c,
                          const float* t, const float* x, const float* gout,
                          const float* out, const float* lse, float slope,
                          float* att, float* dpre, float* dc, float* ws,
                          int n_rows, int n_out, int run, int group, int d,
                          int n_warps, cudaStream_t stream) {
  gat_bwd::Args args{};
  args.c = c;
  args.t = t;
  args.out = out;
  args.lse = lse;
  args.slope = slope;
  args.o1 = dpre;
  args.o2 = att;
  args.sums = dc;
  args.ws = ws;
  return gat_bwd::launch<gat_bwd::Src::kRank1>(ptr, col, gout, x, args,
                                               n_rows, n_out, run, group, d,
                                               n_warps, stream);
}

// The same over x [n_cols, d] stored in bfloat16 (the generic form's
// bfloat16 payload, rank1_gat.py:540-760): x widened in registers, t as
// the caller rounded it, every other input, output and sum float32.
extern "C" int r1_bwd_bf16(const int* ptr, const int* col, const float* c,
                           const float* t, const __nv_bfloat16* x,
                           const float* gout, const float* out,
                           const float* lse, float slope, float* att,
                           float* dpre, float* dc, float* ws, int n_rows,
                           int n_out, int run, int group, int d, int n_warps,
                           cudaStream_t stream) {
  gat_bwd::Args args{};
  args.c = c;
  args.t = t;
  args.out = out;
  args.lse = lse;
  args.slope = slope;
  args.o1 = dpre;
  args.o2 = att;
  args.sums = dc;
  args.ws = ws;
  return gat_bwd::launch<gat_bwd::Src::kRank1>(ptr, col, gout, x, args,
                                               n_rows, n_out, run, group, d,
                                               n_warps, stream);
}

extern "C" const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
