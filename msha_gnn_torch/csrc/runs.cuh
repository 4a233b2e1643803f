// The edge-run schedule of the CSR walks that sum edges into their rows:
// csr_spmm_f32 and seg_reduce_f32 (spmm.cu), r1l_bwd_f32's and
// r1_bwd_f32's dc and csr_spmm_dw_f32's dx (rank1_gat.cu, gat_bwd.cuh) and
// the GAT forwards' online softmaxes (gat_fwd.cuh); the per-edge walks of
// gat_bwd.cuh use its runs too.
//
// The CSR slots [0, n_edges) are cut into runs of `run` consecutive slots,
// whatever the row lengths, and each run goes to one worker (a warp, or one
// thread where the row width is 1).  A worker finds its first row by a
// binary search of ptr and walks its slots, advancing the row as the slots
// pass ptr[row + 1].  So a row of any length is spread over as many workers
// as it has runs, and no row sets a tail alone.
//
// Every output row is written exactly once, in a fixed order (no atomics):
//   * a row that lies wholly inside one run is written by that run;
//   * a row that crosses a run boundary leaves one piece in each run it
//     touches: the run where it begins writes its piece to that run's tail
//     partial, every later run to its head partial (a run that the row
//     covers from end to end has only that one piece, a head).  A second
//     grid adds them in run order: out[r] = tail[k] + head[k + 1] + ... +
//     head[k_end], by the worker of run k, where r begins (run k records
//     r in cross[k], -1 when its last row ends inside it);
//   * an empty row sits between two slots and has none of its own: it is
//     zeroed by the run that holds slot ptr[r] (at the run's start when
//     ptr[r] is the run's first slot, where the binary search lands past
//     it), and the rows with ptr[r] == n_edges by the run that holds the
//     last slot.  With no edges at all, run 0 zeroes every row.
// Slots past ptr[n_rows] (pads) are never read.
//
// Rows of x (and the other gathered rows) come as float or, for the
// bfloat16 payload, as __nv_bfloat16: ldg_vec loads either into float
// registers, so every walk sums in float32 whatever the row type.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace runs {

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

// row_of by a whole warp, every lane calling it with the same e: each round
// the 32 lanes probe 32 evenly spaced rows of the candidates and a ballot
// keeps the stretch that holds the answer, so a pointer of n rows takes
// about log32(n) dependent loads (3 at 4,267 rows) where row_of takes
// log2(n) (12).
__device__ __forceinline__ int warp_row_of(const int* __restrict__ ptr,
                                           int n_rows, int e, int lane) {
  int lo = 0;  // ptr[lo] <= e; the answer lies in [lo, hi)
  int hi = n_rows;
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int probe = lo + lane * step;
    const unsigned le = __ballot_sync(
        0xffffffffu, probe < hi && __ldg(ptr + probe) <= e);
    const int t = 31 - __clz(le);
    hi = min(hi, lo + (t + 1) * step);
    lo += t * step;
  }
  const int probe = lo + lane;
  const unsigned le =
      __ballot_sync(0xffffffffu, probe < hi && __ldg(ptr + probe) <= e);
  return lo + 31 - __clz(le);
}

// The first of the empty rows just before row r0 that begin at `first`
// (r0 itself when there are none): rows [first_owned, r0) belong to the run
// that starts at `first`.
__device__ __forceinline__ int first_owned(const int* __restrict__ ptr, int r0,
                                           int first) {
  int r = r0;
  while (r > 0 && __ldg(ptr + r - 1) == first) --r;
  return r;
}

enum Target { kOut = 0, kHead = 1, kTail = 2 };

// Where the piece of the row [begin, end) that the run [first, last) holds
// goes: its own output row, the run's head partial or its tail partial.
__device__ __forceinline__ Target target(int begin, int end, int first,
                                         int last) {
  if (begin < first) return kHead;
  return end > last ? kTail : kOut;
}

// The slots [first, last) of run k, or false when the run holds no edge.
__device__ __forceinline__ bool bounds(int64_t k, int run, int n_edges,
                                       int& first, int& last) {
  const int64_t f = k * run;
  if (f >= n_edges) return false;
  first = static_cast<int>(f);
  last = static_cast<int>(f + run < n_edges ? f + run
                                            : static_cast<int64_t>(n_edges));
  return true;
}

// The row that begins in run k and ends after it, as the run recorded it
// in cross[k] (-1 for none, or k past the runs that hold edges); k_end is
// the run that holds its last slot.
__device__ __forceinline__ int crossing_row(const int* __restrict__ ptr,
                                            const int* __restrict__ cross,
                                            int n_edges, int run, int64_t k,
                                            int64_t& k_end) {
  if (k * run >= n_edges) return -1;
  const int r = cross[k];
  if (r >= 0) k_end = (__ldg(ptr + r + 1) - 1) / run;
  return r;
}

// The d = 1 sum of the row that begins in run k and ends after it:
// out[r] = tail[k] + head[k + 1] + ... + head[k_end], added in run order;
// nothing when no row crosses out of run k.
__device__ __forceinline__ void add_crossing(const int* __restrict__ ptr,
                                             const float* __restrict__ head,
                                             const float* __restrict__ tail,
                                             const int* __restrict__ cross,
                                             float* __restrict__ out,
                                             int n_rows, int run, int64_t k) {
  int64_t k_end = 0;
  const int r = crossing_row(ptr, cross, __ldg(ptr + n_rows), run, k, k_end);
  if (r < 0) return;
  float v = tail[k];
#pragma unroll 8
  for (int64_t j = k + 1; j <= k_end; ++j) v += head[j];
  out[r] = v;
}

// The grid that adds up the rows crossing runs at width d: for each run k,
// out[r] = tail[k] + head[k + 1] + ... + head[k_end] for the row r that
// begins in it (head and tail [n_runs, d]), kLanes workers a run (a warp,
// lanes over features, or one thread at d = 1).  The sums of csr_spmm_f32
// and seg_reduce_f32 (spmm.cu), r1_bwd_f32's dc and csr_spmm_dw_f32's dx
// (gat_bwd.cuh) take it as their second grid.
template <int kLanes>
__global__ void fixup_kernel(const int* __restrict__ ptr,
                             const float* __restrict__ head,
                             const float* __restrict__ tail,
                             const int* __restrict__ cross,
                             float* __restrict__ out, int n_rows, int run,
                             int d) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t k = t / kLanes;
  const int lane = static_cast<int>(t % kLanes);
  int64_t k_end = 0;
  const int r = crossing_row(ptr, cross, __ldg(ptr + n_rows), run, k, k_end);
  if (r < 0) return;
  for (int f = lane; f < d; f += kLanes) {
    float v = tail[k * d + f];
#pragma unroll 8
    for (int64_t j = k + 1; j <= k_end; ++j) v += head[j * d + f];
    out[static_cast<int64_t>(r) * d + f] = v;
  }
}

// kVec consecutive floats of a read-only global row, through the
// read-only cache (a float4 or float2 load where kVec is 4 or 2: p must be
// aligned to it).
template <int kVec>
__device__ __forceinline__ void ldg_vec(const float* __restrict__ p,
                                        float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else if constexpr (kVec == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

// kVec consecutive bfloat16 values of a read-only global row, widened to
// float: 8, 4 or 2 bytes a load (p aligned to it).  A bfloat16 is the top
// half of a float32, so widening is a shift; the value at the lower
// address sits in the low half of the loaded word.
template <int kVec>
__device__ __forceinline__ void ldg_vec(const __nv_bfloat16* __restrict__ p,
                                        float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = __uint_as_float(t.x << 16);
    v[1] = __uint_as_float(t.x & 0xffff0000u);
    v[2] = __uint_as_float(t.y << 16);
    v[3] = __uint_as_float(t.y & 0xffff0000u);
  } else if constexpr (kVec == 2) {
    const unsigned t = __ldg(reinterpret_cast<const unsigned*>(p));
    v[0] = __uint_as_float(t << 16);
    v[1] = __uint_as_float(t & 0xffff0000u);
  } else {
    const unsigned short t =
        __ldg(reinterpret_cast<const unsigned short*>(p));
    v[0] = __uint_as_float(static_cast<unsigned>(t) << 16);
  }
}

// A row pointer's address as the alignment rules for float rows read it:
// kVec bfloat16 values take the place of kVec floats at half the bytes, so
// a bfloat16 address counts twice.
template <typename T>
inline uintptr_t float_at(const T* p) {
  return reinterpret_cast<uintptr_t>(p) * (sizeof(float) / sizeof(T));
}

// The same from any memory (shared memory included).
template <int kVec>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else if constexpr (kVec == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

// kVec consecutive floats stored to p, aligned as for load_vec.
template <int kVec>
__device__ __forceinline__ void store_vec(float* __restrict__ p,
                                          const float (&v)[kVec]) {
  if constexpr (kVec == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (kVec == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// Runs needed for n_slots slots (at least one: with no edges, run 0 zeroes
// the output).
inline int64_t count(int64_t n_slots, int run) {
  const int64_t n = (n_slots + run - 1) / run;
  return n > 0 ? n : 1;
}

}  // namespace runs
