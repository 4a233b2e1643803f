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
//     covers from end to end has only that one piece, a head).  Run k
//     records in cross[k] the row that begins in it and leaves it (its
//     tail's row), kThrough when its one piece continues a row from before
//     it past its end, kClosed when its last row ends inside it
//     (cross_code).  The fix-up grids below add the pieces up;
//   * an empty row sits between two slots and has none of its own: it is
//     zeroed by the run that holds slot ptr[r] (at the run's start when
//     ptr[r] is the run's first slot, where the binary search lands past
//     it), and the rows with ptr[r] == n_edges by the run that holds the
//     last slot.  With no edges at all, run 0 zeroes every row.
// Slots past ptr[n_rows] (pads) are never read.
//
// The fix-up of the sums (fixup_kernel, two levels).  Read in run order,
// the pieces form segments: a crossing row's tail, then its heads up to the
// run where it ends.  Level 1: a block of kFixThreads threads takes a
// chunk of consecutive runs, Fix<>::kChunk of them: 512 at d = 1 (256
// threads over runs, 2 runs a thread) and 64 above (8 warps over runs, 8
// runs a warp, lanes over a tile of 32 features, a block a tile).  Each
// worker adds its runs' pieces left to right, then the block joins the
// workers' stretches in a fixed binary tree (join below: worker w with
// w + 1, then pairs with pairs).  A
// segment that ends inside the chunk is written to its row when the join
// that holds its last piece takes place; the chunk leaves, one level up,
// the same three things a run leaves: the pieces of the row entering it
// (its head), those of the row leaving it (its tail) and its cross code.
// Level 2: a worker a chunk adds, for each row that leaves chunk c, the
// chunk's tail and the heads of chunks c + 1 .. c_end in chunk order (a
// thread at d = 1, a warp above).  Rows that begin and end in one chunk,
// the rows of every graph without a hub, end at level 1; a row's order of
// additions is fixed by the chunks, workers and tree, so two launches give
// the same bits, whatever the card's scheduling.
//
// Bound of the fix-up: latency, not bytes.  Its bytes are those of the
// partials, two rows a run (about 4 MB a launch at 16,300 runs of d 32).
// The first design gave each crossing row to one worker, which added
// tail[k] + head[k + 1] + ... + head[k_end] alone, a few loads in flight at
// a time: receiver 0 of the 50 M-edge benchmark graph holds about 1.6 M
// slots of each of its 12 slices, so one warp walked about 6,200 partials
// of d 32 (0.613 ms a launch, about 99 ns a partial) and one thread about
// 50,000 at d = 1 (1.230 ms, about 25 ns), while the other 131 SMs idled:
// 22.5 ms of a 53.5 ms training step.  Now a worker adds at most 8 runs'
// partials at level 1, with all their loads in flight, the block's tree 8
// levels deep at most, and one partial a chunk at level 2 (about 98 for
// that row at both widths): 7.4 and 8.6 us a launch there.  The chunk
// sizes come from a sweep (PERF.md): at d = 1, 512 runs cost the hub 1.6
// us more than 1,024 and the short rows 1-2% less; above, 64 runs beat 256
// by 1.1 us on the hub and 10% on the linkpred graph's short rows, whose
// fix-up time is a warp's walk of its runs at level 1.
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

// What cross[k] holds besides a row (the walks that sum rows; the GAT
// forwards' and r1l_bwd_f32's walks record kClosed for both).
constexpr int kClosed = -1;   // no row leaves the run across its end
constexpr int kThrough = -2;  // the run's one piece continues a row past it

// cross[k] of the run [first, last) whose last row piece is that of row
// `row` [begin, end).
__device__ __forceinline__ int cross_code(int row, int begin, int end,
                                          int first, int last) {
  if (end <= last) return kClosed;
  return begin < first ? kThrough : row;
}

// The row that begins in unit k and ends after it, as the unit recorded it
// in cross[k] (negative for none, or k past the units that hold edges);
// k_end is the unit that holds its last slot.  A unit is `span` slots: a
// run, or a chunk of runs.
__device__ __forceinline__ int crossing_row(const int* __restrict__ ptr,
                                            const int* __restrict__ cross,
                                            int n_edges, int64_t span,
                                            int64_t k, int64_t& k_end) {
  if (k * span >= n_edges) return -1;
  const int r = cross[k];
  if (r >= 0) k_end = (__ldg(ptr + r + 1) - 1) / span;
  return r;
}

// The d = 1 sum of the row that begins in run k and ends after it:
// out[r] = tail[k] + head[k + 1] + ... + head[k_end], added in run order;
// nothing when no row crosses out of run k (r1l_bwd_f32's dc).
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

// The fix-up's shape (the design note above): threads a block, and runs a
// worker of level 1 at d = 1 and above.  spmm.py's FIX_THREADS, FIX_PER_D1
// and FIX_PER size the workspace from the same numbers.
constexpr int kFixThreads = 256;
constexpr int kFixPerD1 = 2;
constexpr int kFixPer = 8;

// kLanes: the lanes a worker, 1 at d = 1 (a thread), 32 above (a warp).
template <int kLanes>
struct Fix {
  static constexpr int kWorkers = kFixThreads / kLanes;
  static constexpr int kPer = kLanes == 1 ? kFixPerD1 : kFixPer;
  static constexpr int kChunk = kWorkers * kPer;  // runs a chunk
};

// Runs a chunk at width d.
inline int chunk_runs(int d) {
  return d == 1 ? Fix<1>::kChunk : Fix<32>::kChunk;
}

// One level's partials in the workspace, n units (runs or chunks) of width
// d: head and tail [n, d] each, then cross [n] (int32).
struct Level {
  float* head;
  float* tail;
  int* cross;
};

__host__ __device__ inline int64_t level_floats(int64_t n, int d) {
  return n * (2 * d + 1);
}

__host__ __device__ inline Level level_at(float* ws, int64_t n, int d) {
  return {ws, ws + n * d, reinterpret_cast<int*>(ws + 2 * n * d)};
}

// A stretch of consecutive runs (or chunks), its pieces added as far as
// they go: x its cross code (kClosed, kThrough, or the row that leaves
// across its end), e the pieces of the row that enters across its start
// (read only when one does), t those of row x.  join makes (x, e, t) the
// stretch followed by (xr, er, tr), and writes the row that the left one
// lets out and the right one ends (out_f: out's column of this lane's
// feature, rows d apart).
__device__ __forceinline__ void join(int& x, float& e, float& t, int xr,
                                     float er, float tr,
                                     float* __restrict__ out_f, int d,
                                     bool mine) {
  if (x == kThrough) {
    e += er;
    x = xr;
    t = tr;
  } else if (x >= 0) {
    if (xr == kThrough) {
      t += er;
    } else {
      if (mine) out_f[static_cast<int64_t>(x) * d] = t + er;
      x = xr;
      t = tr;
    }
  } else {
    x = xr;
    t = tr;
  }
}

// Level 1, a block a chunk of the runs that hold edges (above d = 1, a tile
// of 32 features on blockIdx.y).  Each worker loads all its runs' partials
// at once and joins them left to right; the tree over the workers takes
// its steps inside a warp by shuffles (d = 1: threads are the workers) or
// in warp 0's registers (the warps are the workers), after one barrier.
template <int kLanes>
__device__ __forceinline__ void sum_chunk(const int* __restrict__ ptr,
                                          float* __restrict__ ws,
                                          float* __restrict__ out, int n_rows,
                                          int64_t n_runs, int run, int d) {
  using F = Fix<kLanes>;
  constexpr int kWarps = kFixThreads / 32;
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ int sx[kWarps];
  __shared__ float se[kWarps][kLanes];
  __shared__ float st[kWarps][kLanes];
  const int64_t c = blockIdx.x;
  const int64_t held = (__ldg(ptr + n_rows) + static_cast<int64_t>(run) - 1) /
                       run;  // runs that hold edges
  if (c * F::kChunk >= held) return;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int f = kLanes == 1 ? 0 : blockIdx.y * 32 + lane;
  const bool mine = f < d;
  float* out_f = out + f;
  const Level lo = level_at(ws, n_runs, d);
  const Level hi = level_at(ws + level_floats(n_runs, d),
                            (n_runs + F::kChunk - 1) / F::kChunk, d);
  const int64_t j0 =
      c * F::kChunk + static_cast<int64_t>(threadIdx.x / kLanes) * F::kPer;
  const int n_mine = static_cast<int>(
      held - j0 < F::kPer ? (held > j0 ? held - j0 : 0) : F::kPer);
  // the worker's runs; an idle one (past the last run with edges) is
  // (kClosed, 0, 0)
  int xs[F::kPer];
  float es[F::kPer];
  float ts[F::kPer];
#pragma unroll
  for (int u = 0; u < F::kPer; ++u) {
    const int64_t j = j0 + u;
    const bool ok = u < n_mine;
    xs[u] = ok ? lo.cross[j] : kClosed;
    es[u] = ok && mine ? lo.head[j * d + f] : 0.0f;
    ts[u] = ok && mine ? lo.tail[j * d + f] : 0.0f;
  }
  int x = xs[0];
  float e = es[0];
  float t = ts[0];
#pragma unroll
  for (int u = 1; u < F::kPer; ++u) {
    if (u < n_mine) join(x, e, t, xs[u], es[u], ts[u], out_f, d, mine);
  }
  // the tree: at step s, worker w (a multiple of 2 s) takes in w + s
  if constexpr (kLanes == 1) {
#pragma unroll
    for (int s = 1; s < 32; s *= 2) {
      const int xr = __shfl_down_sync(kAll, x, s);
      const float er = __shfl_down_sync(kAll, e, s);
      const float tr = __shfl_down_sync(kAll, t, s);
      if (lane % (2 * s) == 0) join(x, e, t, xr, er, tr, out_f, d, mine);
    }
    if (lane == 0) {
      sx[warp] = x;
      se[warp][0] = e;
      st[warp][0] = t;
    }
  } else {
    if (lane == 0) sx[warp] = x;
    se[warp][lane] = e;
    st[warp][lane] = t;
  }
  __syncthreads();
  if (warp != 0) return;
  if constexpr (kLanes == 1) {  // lane i: the stretch of worker 32 i
    const bool live = lane < kWarps;
    x = live ? sx[lane] : kClosed;
    e = live ? se[lane][0] : 0.0f;
    t = live ? st[lane][0] : 0.0f;
#pragma unroll
    for (int s = 1; s < kWarps; s *= 2) {
      const int xr = __shfl_down_sync(kAll, x, s);
      const float er = __shfl_down_sync(kAll, e, s);
      const float tr = __shfl_down_sync(kAll, t, s);
      if (live && lane % (2 * s) == 0) {
        join(x, e, t, xr, er, tr, out_f, d, mine);
      }
    }
    if (lane != 0) return;
  } else {  // the warps' stretches, this lane's feature
    int xw[kWarps];
    float ew[kWarps];
    float tw[kWarps];
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      xw[i] = sx[i];
      ew[i] = se[i][lane];
      tw[i] = st[i][lane];
    }
#pragma unroll
    for (int s = 1; s < kWarps; s *= 2) {
#pragma unroll
      for (int i = 0; i < kWarps; i += 2 * s) {
        join(xw[i], ew[i], tw[i], xw[i + s], ew[i + s], tw[i + s], out_f, d,
             mine);
      }
    }
    x = xw[0];
    e = ew[0];
    t = tw[0];
  }
  if (lane == 0 && blockIdx.y == 0) hi.cross[c] = x;
  if (mine) {
    hi.head[c * d + f] = e;
    hi.tail[c * d + f] = t;
  }
}

// Level 2, a worker a chunk: out[r] = tail[c] + head[c + 1] + ... +
// head[c_end] over the chunks' partials, for the row r that leaves chunk c.
template <int kLanes>
__device__ __forceinline__ void sum_chain(const int* __restrict__ ptr,
                                          float* __restrict__ ws,
                                          float* __restrict__ out, int n_rows,
                                          int64_t n_runs, int run, int d) {
  using F = Fix<kLanes>;
  const int64_t n_chunks = (n_runs + F::kChunk - 1) / F::kChunk;
  const Level hi = level_at(ws + level_floats(n_runs, d), n_chunks, d);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t c = i / kLanes;
  if (c >= n_chunks) return;
  int64_t c_end = 0;
  const int r =
      crossing_row(ptr, hi.cross, __ldg(ptr + n_rows),
                   static_cast<int64_t>(run) * F::kChunk, c, c_end);
  if (r < 0) return;
  for (int f = static_cast<int>(i % kLanes); f < d; f += kLanes) {
    float v = hi.tail[c * d + f];
#pragma unroll 16
    for (int64_t j = c + 1; j <= c_end; ++j) v += hi.head[j * d + f];
    out[static_cast<int64_t>(r) * d + f] = v;
  }
}

// The fix-up grids of the sums of csr_spmm_f32 and seg_reduce_f32
// (spmm.cu), r1_bwd_f32's dc and csr_spmm_dw_f32's dx (gat_bwd.cuh): level
// kLevel (1 or 2) at kLanes lanes a worker.  One name for both levels, so
// that a trace reads the whole fix-up under runs::fixup_kernel.
template <int kLevel, int kLanes>
__global__ void __launch_bounds__(kFixThreads)
fixup_kernel(const int* __restrict__ ptr, float* __restrict__ ws,
             float* __restrict__ out, int n_rows, int64_t n_runs, int run,
             int d) {
  if constexpr (kLevel == 1) {
    sum_chunk<kLanes>(ptr, ws, out, n_rows, n_runs, run, d);
  } else {
    sum_chain<kLanes>(ptr, ws, out, n_rows, n_runs, run, d);
  }
}

template <int kLanes>
int launch_fixup(const int* ptr, float* ws, float* out, int n_rows,
                 int64_t n_runs, int run, int d, cudaStream_t stream) {
  const int64_t n_chunks =
      (n_runs + Fix<kLanes>::kChunk - 1) / Fix<kLanes>::kChunk;
  const dim3 grid(static_cast<unsigned>(n_chunks),
                  kLanes == 1 ? 1u : static_cast<unsigned>((d + 31) / 32));
  fixup_kernel<1, kLanes><<<grid, kFixThreads, 0, stream>>>(
      ptr, ws, out, n_rows, n_runs, run, d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return static_cast<int>(err);
  fixup_kernel<2, kLanes>
      <<<static_cast<unsigned>((n_chunks * kLanes + kFixThreads - 1) /
                               kFixThreads),
         kFixThreads, 0, stream>>>(ptr, ws, out, n_rows, n_runs, run, d);
  return static_cast<int>(cudaGetLastError());
}

// The fix-up of a walk that has summed rows of width d over n_runs runs of
// `run` slots into out and the runs' partials at ws, which holds the
// chunks' after them: (n_runs + n_chunks) (2 d + 1) floats, n_chunks =
// ceil(n_runs / chunk_runs(d)).  Level 1, then level 2 where there is more
// than one chunk.
// Returns cudaGetLastError() after the launches (0 = launched).
inline int fixup(const int* ptr, float* ws, float* out, int n_rows,
                 int64_t n_runs, int run, int d, cudaStream_t stream) {
  if (d == 0) return 0;
  if (d == 1) {
    return launch_fixup<1>(ptr, ws, out, n_rows, n_runs, run, d, stream);
  }
  return launch_fixup<32>(ptr, ws, out, n_rows, n_runs, run, d, stream);
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
