// Softmax of per-edge logits over each CSR row, in float32, and its
// vector-Jacobian product: seg_softmax_fwd_f32 and seg_softmax_bwd_f32.
//
// For a CSR row r with edges e in [ptr[r], ptr[r+1]) and a per-edge mask
// k_e (all true when no mask is given):
//
//   forward   m_r = max_{k_e} l_e,  s_r = sum_{k_e} exp(l_e - m_r),
//             lse[r] = m_r + log(max(s_r, 1e-30)),
//             att[e] = k_e ? exp(l_e - lse[r]) : 0
//   backward  rs_r = sum_e att_e g_e,   dl[e] = att_e g_e - att_e rs_r
//
// A row with no unmasked edge (an empty row too) has m = NEG (-1e30) and
// s = 0, so lse = NEG + log(1e-30).  Slots from n_edges = ptr[n_rows] up
// to n_slots (the graph's pads) are written as 0.
//
// With dropout (kDrop: a seed on the card and a rate) the attention's keep
// mask rides the same walk: k_e = gat::keep_scale(e, seed, rate) of
// gat_common.cuh, 1/(1-rate) where slot e is kept and 0 where dropped (the
// hash of rank1_gat.py:85 _keep_scale, which the TPU package applies to
// the attention after the softmax).  The forward also writes
// att_k[e] = att[e] k_e, one float multiply a slot, so its bits are those
// of att * k; the backward takes g_k, the cotangent of att_k, and sums
// g_e = g_k[e] k_e, the bits of the cotangent that att * k passes back.  No
// mask is stored: both directions hash the slot.
//
// Replaces three TPU kernels of msha_gnn_tpu/ops/pallas/softmax.py:
//   * _stats_kernel (:56): the online (m, s) per row over chunk visits;
//   * _expand_kernel (:86): a per-row value (lse forward, rs backward) to
//     the row's edges;
//   * _rowsum_kernel (:102): per-edge values to per-row sums (rs).
// There each step is its own grid, because per-row state lives in VMEM
// across a block's chunk visits and row values reach the edges by one-hot
// selects.  Here both entries are one walk of the edge runs (runs.cuh),
// told apart by a template tag (Kind): a per-row reduction of per-edge
// scalars, then a per-edge write that needs the row's result.
//
// The TPU operator also runs _expand_kernel and _rowsum_kernel alone, as
// the differentiable row broadcast v[row] -> v[senders[e]] of
// SegmentSoftmaxOperator.broadcast_rows (softmax.py:338-364) and its
// adjoint.  The broadcast is seg_expand_f32 below: no reduction, so one
// grid of warps over runs of slots, each lane finding its slot's row by
// stepping the pointer from its round's first row; bound by bytes (the
// pointer and v read once, out [n_slots] written once).  The adjoint, a
// sorted row sum, is seg_reduce_f32 (spmm.cu) at d = 1.
//
// The re-mask hazard of softmax.py:73-78: masked edges take no part in the
// statistics at all (they are not merely set to NEG), so a fully masked row
// keeps s = 0 rather than summing exp(NEG - NEG) = 1 per edge.
//
// Bound: bytes.  The forward reads the pointer, the logits and the mask
// once and writes att [n_slots] and lse once: 2.66 MB on the linkpred
// graph (4,267 rows, 328,012 edges padded to 328,064, no mask), 0.79 us
// at 3.35 TB/s; with dropout att_k too, 3.97 MB, 1.18 us.  The backward
// reads att and g and writes dl: 3.95 MB, 1.18 us.  Two exps an edge (and
// the hash's 14 integer operations) are far below the card's rate.
//
// Why the keep mask is here: as a kernel of its own it wrote 1.3 MB (0.39
// us of HBM time) in a launch that cost several times that, and the
// attention's multiply by it took one more kernel each way; in the walk it
// costs the att_k write and a hash a slot.
//
// Why not one block a row (the first port): the linkpred graph's rows are
// 77 edges on average and 3,842 at most, and a block had to fit the
// longest, so every row got 256 threads of which about 180 loaded nothing,
// and each paid a shuffle tree a warp, a __syncthreads, a serial merge of 8
// warps and a second pass; the 3,842-edge row was still one block's work.
// The forward ran at 21x its byte bound, the backward at 5x.
//
// Design: the slots [0, n_slots) are cut into runs of `run` consecutive
// slots, whatever the row lengths (runs.cuh: bounds, row_of, first_owned,
// target).
//   Grid 1, a warp a run.  The run's pads get 0.  Each row piece in the
//   run is reduced (forward: m and s over the unmasked edges; backward:
//   the sum of att g).  A row that lies wholly inside the run gets its
//   result there, and the run writes lse[r] and the row's per-edge outputs
//   itself (from the slots it holds).  A row that crosses a run boundary
//   leaves its piece in the run's head or tail partial, with its bounds
//   (hrows[k], trows[k]) and, for the row that begins in the run,
//   cross[k].  Empty rows get their lse once, from the run that owns them
//   (runs.cuh).
//   Grid 2, a warp a run.  For each crossing row that touches run k (at
//   most two: the row its first slot continues and the row that begins in
//   it) the worker merges the row's pieces in run order, tail[k0], head[k0
//   + 1], ..., head[k_end], with (+) the online-softmax merge (forward) or
//   + (backward), as a balanced tree over neighbours in batches of 32
//   ((p0 (+) p1) (+) (p2 (+) p3) ..., batches left to right), and writes
//   the row's per-edge outputs for its own slots only; the run where the
//   row begins writes lse[r].  Every run that touches a row forms the same
//   tree over the same pieces, so all reach the same bits, and a long row
//   is written by all its runs in parallel.
//
// A warp a run (run <= 512): lane i loads the run's slots [kC i, kC i +
// kC) at once (kC = run / 32, rounded up to a power of two; 4 floats a load
// where aligned), beside a warp-wide search of ptr whose last round leaves
// the lanes a window of 32 row pointers.  Stepping that window 31 rows at a
// time (a ballot a window) marks where each of the run's rows begins.  Each
// lane folds its slots in order, and a segmented scan over the lanes (reset
// where a row begins) joins the pieces of rows that span lanes, so a run
// costs the same whatever its row count.  Grid 2 loads the rows' bounds and
// the run's slots together, then the rows' pieces, and merges both rows'
// trees at once, in as many shuffle rounds as the pieces need.  A thread a
// run (as csr_spmm_runs_d1_kernel) was 1.03-9x slower at every run length
// (PERF.md), and a warp taking a row piece at a time paid a chain of
// shuffles and exps a row.
// No float atomics: two launches give the same bits.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "gat_common.cuh"
#include "runs.cuh"

namespace seg_softmax {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e30f;
constexpr int kWarpBlock = 128;    // threads a block
constexpr int kMaxChunks = 16;     // a warp holds 16 slots a lane: run <= 512

enum class Kind { kFwd, kBwd };

// What the kernels read and write; an entry reads only its own.
struct Args {
  const float* in;       // kFwd: logits; kBwd: att   [n_slots]
  const float* g;        // kBwd: the cotangent (of att_k with kDrop)
  const uint8_t* mask;   // kFwd: the softmax's mask, or null
  float* out;            // kFwd: att; kBwd: dl       [n_slots]
  float* out_k;          // kFwd with kDrop: att_k    [n_slots]
  float* lse;            // kFwd: [n_rows]
  const int* seed;       // kDrop: one int32 on the card
  float rate;            // kDrop
  float scale;           // kDrop: 1/(1-rate)
  uint32_t key;          // kDrop: *seed, read by each kernel at its start
};

// The keep scale of slot e (kDrop).
__device__ __forceinline__ float keep(const Args& p, int e) {
  return gat::keep_scale(static_cast<uint32_t>(e), p.key, p.rate, p.scale);
}

// A row piece's reduction: kFwd (m, s), kBwd (sum of att g, unused).
using Piece = float2;

// The workspace: the head and tail pieces of each run (a float2 each);
// the bounds [begin, end) of the row that the run's first slot continues
// (hrows) and of the row that begins in the run and ends after it (trows),
// begin -1 for none (int2 each); that tail row (cross, int32, -1 for
// none): 9 n_runs floats.
struct Ws {
  Piece* head;
  Piece* tail;
  int2* hrows;
  int2* trows;
  int* cross;
};

inline Ws ws_of(float* ws, int64_t n_runs) {
  Piece* head = reinterpret_cast<Piece*>(ws);
  int2* hrows = reinterpret_cast<int2*>(ws + 4 * n_runs);
  return {head, head + n_runs, hrows, hrows + n_runs,
          reinterpret_cast<int*>(ws + 8 * n_runs)};
}

// One slot's inputs: kFwd (the logit, 1 if unmasked else 0); kBwd (att, g).
struct Slot {
  float u;
  float v;
};

// e^x as 2^(x log2 e): the card's exp2 unit and one multiply, a third of
// expf's instructions; the product's rounding costs about |x| 6e-8 of
// relative error (1.2e-6 at |x| = 20), below the kernels' tolerance.
__device__ __forceinline__ float exp_(float x) {
  return exp2f(x * 1.4426950408889634f);
}

template <Kind kK, bool kMasked, bool kDrop = false>
struct Op {
  __device__ static __forceinline__ Slot load(const Args& p, int e) {
    if constexpr (kK == Kind::kFwd) {
      return {__ldg(p.in + e), (!kMasked || __ldg(p.mask + e)) ? 1.0f : 0.0f};
    } else if constexpr (kDrop) {
      return {__ldg(p.in + e), __ldg(p.g + e) * keep(p, e)};
    } else {
      return {__ldg(p.in + e), __ldg(p.g + e)};
    }
  }

  // A slot loaded by the plain Op: its g scaled by the keep mask as load()
  // scales it (grid 2 loads every slot of its run but writes, and so
  // hashes, only the crossing rows').
  __device__ static __forceinline__ Slot scaled(const Args& p, Slot s,
                                                int e) {
    if constexpr (kK == Kind::kBwd && kDrop) s.v *= keep(p, e);
    return s;
  }

  // Slot e's output: att (and att_k with kDrop), or dl.
  __device__ static __forceinline__ void put(const Args& p, int e, float v) {
    p.out[e] = v;
    if constexpr (kK == Kind::kFwd && kDrop) p.out_k[e] = v * keep(p, e);
  }

  __device__ static __forceinline__ Piece identity() {
    return kK == Kind::kFwd ? make_float2(kNeg, 0.0f)
                            : make_float2(0.0f, 0.0f);
  }

  // a (+) b into a: the online-softmax merge, or the sum.
  __device__ static __forceinline__ void merge(Piece& a, Piece b) {
    if constexpr (kK == Kind::kFwd) {
      const float m = fmaxf(a.x, b.x);
      a.y = fmaf(b.y, exp_(b.x - m), a.y * exp_(a.x - m));
      a.x = m;
    } else {
      a.x += b.x;
    }
  }

  // The row's value from its merged pieces: lse, or rs.
  __device__ static __forceinline__ float value(Piece a) {
    if constexpr (kK == Kind::kFwd) {
      return a.x + logf(fmaxf(a.y, 1e-30f));
    } else {
      return a.x;
    }
  }

  // The slot's output from its row's value.
  __device__ static __forceinline__ float emit(Slot s, float val) {
    if constexpr (kK == Kind::kFwd) {
      return s.v != 0.0f ? exp_(s.u - val) : 0.0f;
    } else {
      return fmaf(-s.u, val, s.u * s.v);
    }
  }

  // The row's own output (lse; the backward has none).
  __device__ static __forceinline__ void row(const Args& p, int r, float val) {
    if constexpr (kK == Kind::kFwd) p.lse[r] = val;
  }
};

// Whether a warp may load its lanes' slots 4 at a time: 16-byte floats
// and 4-byte mask words at the run's first slot (kC a multiple of 4).
template <Kind kK, bool kMasked, int kC>
__device__ __forceinline__ bool vector_ok(const Args& p, int first) {
  const auto at = [](const void* q, int align) {
    return (reinterpret_cast<uintptr_t>(q) & (align - 1)) == 0;
  };
  return kC % 4 == 0 && first % 4 == 0 && at(p.in, 16) &&
         (kK == Kind::kFwd || at(p.g, 16)) && (!kMasked || at(p.mask, 4));
}

// A lane's kC consecutive slots [e0, e0 + kC), those before ef: 4 at a
// time when `vec` and the lane's slots all lie before ef.
template <Kind kK, bool kMasked, bool kDrop, int kC>
__device__ __forceinline__ void load_lane(const Args& p, int e0, int ef,
                                          bool vec, Slot (&v)[kC]) {
  using O = Op<kK, kMasked, kDrop>;
  if (vec && e0 + kC <= ef) {
#pragma unroll
    for (int q = 0; q < kC; q += 4) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(p.in + e0 + q));
      float w[4] = {1.0f, 1.0f, 1.0f, 1.0f};
      if constexpr (kK == Kind::kBwd) {
        const float4 g = __ldg(reinterpret_cast<const float4*>(p.g + e0 + q));
        w[0] = g.x;
        w[1] = g.y;
        w[2] = g.z;
        w[3] = g.w;
        if constexpr (kDrop) {
#pragma unroll
          for (int b = 0; b < 4; ++b) w[b] *= keep(p, e0 + q + b);
        }
      } else if constexpr (kMasked) {
        const unsigned m =
            __ldg(reinterpret_cast<const unsigned*>(p.mask + e0 + q));
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          w[b] = ((m >> (8 * b)) & 0xffu) != 0u ? 1.0f : 0.0f;
        }
      }
      v[q] = {u.x, w[0]};
      v[q + 1] = {u.y, w[1]};
      v[q + 2] = {u.z, w[2]};
      v[q + 3] = {u.w, w[3]};
    }
  } else {
#pragma unroll
    for (int u = 0; u < kC; ++u) {
      v[u] = e0 + u < ef ? O::load(p, e0 + u) : Slot{0.0f, 0.0f};
    }
  }
}

// The slots of run k: [first, last) of [0, n_slots), the edges [first, ef).
struct Run {
  int first;
  int last;
  int ef;
};

__device__ __forceinline__ Run run_of(int64_t k, int run, int n_edges,
                                      int n_slots) {
  const int64_t f = k * run;
  const int64_t l = f + run < n_slots ? f + run : n_slots;
  return {static_cast<int>(f), static_cast<int>(l),
          static_cast<int>(l < n_edges ? l : n_edges)};
}

// No crossing row.
__device__ __forceinline__ int2 no_row() { return make_int2(-1, -1); }

// The last row r with ptr[r] <= e, by the warp-wide search of
// runs::warp_row_of, whose last round also leaves a window of the pointer:
// lane i holds ptr[wb + i] (clamped at n_rows), with wb <= r < wb + 32.
__device__ __forceinline__ int window_row_of(const int* __restrict__ ptr,
                                             int n_rows, int e, int lane,
                                             int& wb, int& win) {
  int lo = 0;  // ptr[lo] <= e; the answer lies in [lo, hi)
  int hi = n_rows;
  while (hi - lo > kWarp) {
    const int step = (hi - lo + kWarp - 1) / kWarp;
    const int probe = lo + lane * step;
    const unsigned le =
        __ballot_sync(kFull, probe < hi && __ldg(ptr + probe) <= e);
    const int t = 31 - __clz(le);
    hi = min(hi, lo + (t + 1) * step);
    lo += t * step;
  }
  wb = lo;
  win = __ldg(ptr + min(lo + lane, n_rows));
  return lo + 31 - __clz(__ballot_sync(kFull, lo + lane < hi && win <= e));
}

// One slot folded into a row piece: the online (m, s), or the sum.
template <Kind kK>
__device__ __forceinline__ void fold(Piece& a, Slot s) {
  if constexpr (kK == Kind::kFwd) {
    if (s.v != 0.0f) {
      const float m = fmaxf(a.x, s.u);
      a.y = fmaf(a.y, exp_(a.x - m), exp_(s.u - m));
      a.x = m;
    }
  } else {
    a.x = fmaf(s.u, s.v, a.x);
  }
}

// A piece from another lane (the backward's pieces use x alone).
template <Kind kK>
__device__ __forceinline__ Piece shfl_up(Piece v, int o) {
  return make_float2(__shfl_up_sync(kFull, v.x, o),
                     kK == Kind::kFwd ? __shfl_up_sync(kFull, v.y, o) : 0.0f);
}

template <Kind kK>
__device__ __forceinline__ Piece shfl_xor(Piece v, int o) {
  return make_float2(__shfl_xor_sync(kFull, v.x, o),
                     kK == Kind::kFwd ? __shfl_xor_sync(kFull, v.y, o) : 0.0f);
}

template <Kind kK>
__device__ __forceinline__ Piece shfl_from(Piece v, int src) {
  return make_float2(__shfl_sync(kFull, v.x, src),
                     kK == Kind::kFwd ? __shfl_sync(kFull, v.y, src) : 0.0f);
}

// A warp's shared memory: the row that begins at each slot of the run
// (slot first + i at start[i], -1 for none) and the value (lse or rs) of
// each row that begins in the run, at its first slot.
template <int kC>
struct Staged {
  int start[kC * kWarp];
  float val[kC * kWarp];
};

// The bounds of the run's first row r0 (the one its first slot lies in)
// and of its last row (the last to begin before ef).
struct Rows {
  int r0_begin;
  int r0_end;
  int last;
  int last_begin;
  int last_end;
};

// Marks where each of the run's rows begins (start) and writes the empty
// rows inside the run (forward), from the window of ptr that
// window_row_of left (lane i holds ptr[wb + i]), stepped 31 rows at a time
// until the window's last pointer reaches ef: lanes 0..30 hold rows whose
// end the next lane holds.
template <Kind kK, bool kMasked, int kC>
__device__ __forceinline__ Rows mark_rows(const int* __restrict__ ptr,
                                          const Args& p, Staged<kC>& sm,
                                          const Run& rk, int n_rows, int wb,
                                          int win, int r0, int lane) {
  using O = Op<kK, kMasked>;
  Rows rows;
  rows.r0_begin = __shfl_sync(kFull, win, r0 - wb);
  rows.r0_end = 0;
  while (true) {
    const int next = __shfl_down_sync(kFull, win, 1);  // ptr[wb + lane + 1]
    if (lane < kWarp - 1 && win < next && win >= rk.first && win < rk.ef) {
      sm.start[win - rk.first] = wb + lane;
    }
    if constexpr (kK == Kind::kFwd) {  // the empty rows inside the run
      if (lane < kWarp - 1 && wb + lane < n_rows && win == next &&
          win > rk.first && win < rk.ef) {
        O::row(p, wb + lane, O::value(O::identity()));
      }
    }
    if (r0 + 1 >= wb && r0 + 1 - wb < kWarp) {
      rows.r0_end = __shfl_sync(kFull, win, r0 + 1 - wb);
    }
    if (__shfl_sync(kFull, win, kWarp - 1) >= rk.ef) break;
    wb += kWarp - 1;
    win = __ldg(ptr + min(wb + lane, n_rows));
  }
  // rows below wb + 31 hold every slot; lane 0 begins before ef
  rows.last = wb + 31 - __clz(__ballot_sync(kFull, win < rk.ef));
  rows.last_begin = __shfl_sync(kFull, win, rows.last - wb);
  rows.last_end = __shfl_sync(kFull, win, rows.last + 1 - wb);
  __syncwarp();
  return rows;
}

// Grid 1's walk of a run, its row starts marked: lane i folds the slots
// [kC i, kC i + kC) of the run in order, closing the rows that begin and
// end there; a segmented scan over the lanes (reset where a row begins)
// gives each lane the piece of the row open at its end, and the lane where
// a row ends closes it.  Its cost does not grow with the run's rows.  The
// rows' values go to `val`, then every lane writes its slots.
template <Kind kK, bool kMasked, bool kDrop, int kC>
__device__ __forceinline__ void lanes_walk(const Args& p, const Ws& ws,
                                           Staged<kC>& sm,
                                           const Slot (&v)[kC], const Run& rk,
                                           int64_t k, const Rows& rows,
                                           int r0, int lane) {
  using O = Op<kK, kMasked, kDrop>;
  const int n = rk.ef - rk.first;
  // my slots: the rows that begin and end in them are closed here; hp is
  // the piece of the row open at my first slot, up to my first row start
  const int a = lane * kC;
  Piece cur = O::identity();
  Piece hp = O::identity();
  int cur_row = -1;
  int cur_start = -1;  // the slot where the last row begun in mine begins
#pragma unroll
  for (int u = 0; u < kC; ++u) {
    const int i = a + u;
    if (i < n) {
      const int r = sm.start[i];
      if (r >= 0) {
        if (cur_start >= 0) {
          const float val = O::value(cur);
          sm.val[cur_start] = val;
          O::row(p, cur_row, val);
        } else {
          hp = cur;
        }
        cur = O::identity();
        cur_row = r;
        cur_start = i;
      }
      fold<kK>(cur, v[u]);
    }
  }
  const bool begins = cur_start >= 0;  // a row begins in my slots
  // the piece of the row open at my last slot, from where it began (or
  // from the run's first slot): a segmented inclusive scan, earlier lanes
  // on the left; and the slot of the last row start at or before my slots
  // (a lane's segment has reset where a row began: last_start >= 0)
  Piece open = cur;
  int last_start = cur_start;
#pragma unroll
  for (int o = 1; o < kWarp; o *= 2) {
    Piece open2 = shfl_up<kK>(open, o);
    const int last2 = __shfl_up_sync(kFull, last_start, o);
    if (lane >= o) {
      if (last_start < 0) {
        O::merge(open2, open);
        open = open2;
      }
      last_start = max(last_start, last2);
    }
  }
  Piece before = shfl_up<kK>(open, 1);  // the row open before my slot
  int open_start = __shfl_up_sync(kFull, last_start, 1);
  if (lane == 0) {
    before = O::identity();
    open_start = -1;
  }
  // that row and its first slot: r0, unless a row began in earlier lanes
  const int open_row = open_start < 0 ? r0 : sm.start[open_start];
  const int open_begin =
      open_start < 0 ? rows.r0_begin : rk.first + open_start;
  const Piece last_piece = shfl_from<kK>(open, kWarp - 1);
  // the open row ends at my first row start (unless it is the row that
  // begins at the run's first slot)
  if (begins && open_begin < rk.first + a) {
    O::merge(before, hp);
    if (open_begin < rk.first) {  // row r0, begun in an earlier run
      ws.head[k] = before;
      ws.hrows[k] = make_int2(open_begin, rows.r0_end);
    } else {
      const float val = O::value(before);
      sm.val[open_start] = val;
      O::row(p, open_row, val);
    }
  }
  // the run's last row, open at the end of the last lane
  const runs::Target to =
      runs::target(rows.last_begin, rows.last_end, rk.first, rk.ef);
  if (lane == 0) {
    if (to == runs::kHead) {
      ws.head[k] = last_piece;
      ws.hrows[k] = make_int2(rows.last_begin, rows.last_end);
    } else if (to == runs::kTail) {
      ws.tail[k] = last_piece;
      ws.trows[k] = make_int2(rows.last_begin, rows.last_end);
      ws.cross[k] = rows.last;
    } else {
      const float val = O::value(last_piece);
      sm.val[rows.last_begin - rk.first] = val;
      O::row(p, rows.last, val);
    }
  }
  __syncwarp();
  // every slot of a row that lies in the run, from its row's value
  const int lo = rows.r0_begin < rk.first ? rows.r0_end : rk.first;
  const int hi = to == runs::kTail ? rows.last_begin : rk.ef;
  int cs = open_begin - rk.first;  // my first slot's row's first slot
#pragma unroll
  for (int u = 0; u < kC; ++u) {
    const int i = a + u;
    if (i < n) {
      if (sm.start[i] >= 0) cs = i;
      const int e = rk.first + i;
      if (e >= lo && e < hi) O::put(p, e, O::emit(v[u], sm.val[cs]));
    }
  }
}

// Grid 1, a warp a run (run <= 32 kC): the run's slots are loaded at once,
// lane i holding the kC consecutive slots from kC i (4-float loads where
// aligned), in flight beside the search of ptr; mark_rows finds the rows'
// starts and lanes_walk reduces the rows from the registers.
template <Kind kK, bool kMasked, bool kDrop, int kC>
__global__ void __launch_bounds__(kWarpBlock)
runs_warp_kernel(const int* __restrict__ ptr, Args p, Ws ws, int n_rows,
                 int n_edges, int n_slots, int64_t n_runs, int run) {
  using O = Op<kK, kMasked, kDrop>;
  __shared__ Staged<kC> staged[kWarpBlock / kWarp];
  const int lane = threadIdx.x % kWarp;
  Staged<kC>& sm = staged[threadIdx.x / kWarp];
  const int64_t k = static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp) +
                    threadIdx.x / kWarp;
  if (k >= n_runs) return;
  const Run rk = run_of(k, run, n_edges, n_slots);
  if constexpr (kDrop) p.key = static_cast<uint32_t>(__ldg(p.seed));
  // lane i holds the run's slots [kC i, kC i + kC)
  Slot v[kC];
  load_lane<kK, kMasked, kDrop, kC>(p, rk.first + lane * kC, rk.ef,
                                    vector_ok<kK, kMasked, kC>(p, rk.first),
                                    v);
  for (int e = max(rk.first, n_edges) + lane; e < rk.last; e += kWarp) {
    O::put(p, e, 0.0f);
  }
  const float empty = O::value(O::identity());
  if (lane == 0) {
    ws.hrows[k] = ws.trows[k] = no_row();
    ws.cross[k] = -1;
  }
  if (rk.first >= n_edges) {  // pads only
    if (k == 0) {  // no edges at all
      for (int r = lane; r < n_rows; r += kWarp) O::row(p, r, empty);
    }
    return;
  }
  int wb = 0;
  int win = 0;
  const int r0 = window_row_of(ptr, n_rows, rk.first, lane, wb, win);
#pragma unroll
  for (int c = 0; c < kC; ++c) sm.start[c * kWarp + lane] = -1;
  if constexpr (kK == Kind::kFwd) {
    // the empty rows that begin at the run's first slot, before r0, are
    // the run's: those in the window, and those below it when the window's
    // first row is one
    if (wb + lane < r0 && win == rk.first) O::row(p, wb + lane, empty);
    if (wb > 0 && __shfl_sync(kFull, win, 0) == rk.first) {
      for (int r = runs::first_owned(ptr, wb, rk.first) + lane; r < wb;
           r += kWarp) {
        O::row(p, r, empty);
      }
    }
  }
  __syncwarp();
  const Rows rows =
      mark_rows<kK, kMasked, kC>(ptr, p, sm, rk, n_rows, wb, win, r0, lane);
  lanes_walk<kK, kMasked, kDrop, kC>(p, ws, sm, v, rk, k, rows, r0, lane);
  if (rk.ef == n_edges) {  // the empty rows after the last edge
    for (int r = rows.last + 1 + lane; r < n_rows; r += kWarp) {
      O::row(p, r, empty);
    }
  }
}

// The pieces of a crossing row [rows.x, rows.y) in run order, p_0 =
// tail[k0], p_i = head[k0 + i] up to k_end, merged in batches of 32: a
// batch by a balanced tree over neighbours, ((p_0 (+) p_1) (+) (p_2 (+)
// p_3)) (+) ..., missing pieces the identity (which merges exactly), and
// the batches left to right.  Every worker of every run that touches the
// row forms the same tree, so all reach the same bits.
//
// By a warp, lane i holding p_{32 b + i}: round o merges each lane's value
// with that of lane i ^ o, the lower lane's on the left, so the two lanes
// keep the same bits.
template <Kind kK, bool kMasked>
struct WarpChain {
  using O = Op<kK, kMasked>;
  int64_t k0 = 0;
  int64_t k_end = -1;  // none
  Piece mine;

  __device__ __forceinline__ Piece piece(const Ws& ws, int64_t i) const {
    if (k0 + i > k_end) return O::identity();
    return i == 0 ? ws.tail[k0] : ws.head[k0 + i];
  }

  // The chain of the row `rows` (begin < 0: none); the lane's piece of
  // the first batch.
  __device__ __forceinline__ void start(const Ws& ws, int2 rows, int run,
                                        int lane) {
    if (rows.x >= 0) {
      k0 = rows.x / run;
      k_end = (rows.y - 1) / run;
    }
    mine = piece(ws, lane);
  }

  // Pieces in a batch (0 for none).
  __device__ __forceinline__ int pieces() const {
    return static_cast<int>(k_end - k0 + 1 < kWarp ? k_end - k0 + 1 : kWarp);
  }

  // Round o merges each lane's piece with that of lane i ^ o, the lower
  // lane's on the left, two chains' rounds interleaved, for as many rounds
  // as n pieces need (more would merge identities, which changes no bit);
  // lane 0's result goes to every lane.
  __device__ static __forceinline__ void tree(Piece& v1, Piece& v2, int lane,
                                              int n) {
    for (int o = 1; o < n; o *= 2) {
      Piece w1 = shfl_xor<kK>(v1, o);
      Piece w2 = shfl_xor<kK>(v2, o);
      if (lane & o) {
        O::merge(w1, v1);
        O::merge(w2, v2);
        v1 = w1;
        v2 = w2;
      } else {
        O::merge(v1, w1);
        O::merge(v2, w2);
      }
    }
    v1 = shfl_from<kK>(v1, 0);
    v2 = shfl_from<kK>(v2, 0);
  }

  // The batches after the first (chains of more than 32 pieces).
  __device__ __forceinline__ void rest(const Ws& ws, int lane,
                                       Piece& st) const {
    for (int64_t b = kWarp; k0 + b <= k_end; b += kWarp) {
      Piece v = piece(ws, b + lane);
      Piece unused = O::identity();
      tree(v, unused, lane, kWarp);
      O::merge(st, v);
    }
  }
};

// Grid 2, a warp a run: the crossing rows that touch run k (hrows[k], the
// row its first slot continues, and trows[k], the row that begins in it),
// each merged as WarpChain says and written on the run's own slots, which
// the warp loads beside the pieces (lane i the slots first + 32 c + i).
template <Kind kK, bool kMasked, bool kDrop, int kC>
__global__ void __launch_bounds__(kWarpBlock)
cross_warp_kernel(Args p, Ws ws, int n_edges, int n_slots, int64_t n_runs,
                  int run) {
  using O = Op<kK, kMasked, kDrop>;
  const int lane = threadIdx.x % kWarp;
  const int64_t k = static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp) +
                    threadIdx.x / kWarp;
  if (k >= n_runs) return;
  const Run rk = run_of(k, run, n_edges, n_slots);
  if (rk.first >= n_edges) return;
  // the two rows' bounds and, beside them, the run's slots
  const int2 hr = ws.hrows[k];
  const int2 tr = ws.trows[k];
  Slot v[kC];  // slot first + 32 c + lane in v[c]: coalesced loads, stores
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int e = rk.first + c * kWarp + lane;
    v[c] = e < rk.ef ? Op<kK, kMasked>::load(p, e) : Slot{0.0f, 0.0f};
  }
  if (hr.x < 0 && tr.x < 0) return;
  if constexpr (kDrop) p.key = static_cast<uint32_t>(__ldg(p.seed));
  // the head row's slots [first, h_end) and the tail row's [t_begin, ef)
  const int h_end = hr.x >= 0 ? min(hr.y, rk.ef) : rk.first;
  const int t_begin = tr.x >= 0 ? tr.x : rk.ef;
  WarpChain<kK, kMasked> head;
  WarpChain<kK, kMasked> tail;
  head.start(ws, hr, run, lane);
  tail.start(ws, tr, run, lane);
  Piece h = head.mine;
  Piece t = tail.mine;
  WarpChain<kK, kMasked>::tree(h, t, lane,
                               max(head.pieces(), tail.pieces()));
  head.rest(ws, lane, h);
  tail.rest(ws, lane, t);
  const float h_val = O::value(h);
  const float t_val = O::value(t);
  if (tr.x >= 0 && lane == 0) O::row(p, ws.cross[k], t_val);
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int e = rk.first + c * kWarp + lane;
    if (e < h_end) {
      O::put(p, e, O::emit(O::scaled(p, v[c], e), h_val));
    } else if (e >= t_begin && e < rk.ef) {
      O::put(p, e, O::emit(O::scaled(p, v[c], e), t_val));
    }
  }
}

// The two grids (kC slots a lane: run <= 32 kC).
template <Kind kK, bool kMasked, bool kDrop, int kC>
void launch_grids(const int* ptr, const Args& p, const Ws& w, int n_rows,
                  int n_edges, int n_slots, int64_t n_runs, int run,
                  unsigned grid, cudaStream_t stream, cudaError_t& err) {
  runs_warp_kernel<kK, kMasked, kDrop, kC><<<grid, kWarpBlock, 0, stream>>>(
      ptr, p, w, n_rows, n_edges, n_slots, n_runs, run);
  err = cudaGetLastError();
  if (err != cudaSuccess) return;
  cross_warp_kernel<kK, kMasked, kDrop, kC><<<grid, kWarpBlock, 0, stream>>>(
      p, w, n_edges, n_slots, n_runs, run);
  err = cudaGetLastError();
}

// Both grids on `stream`, no synchronisation; cudaGetLastError() after
// each (0 = launched).
template <Kind kK, bool kMasked, bool kDrop>
int launch(const int* ptr, const Args& p, float* ws, int n_rows, int n_edges,
           int n_slots, int run, cudaStream_t stream) {
  if (n_rows <= 0 || n_edges < 0 || n_slots < n_edges || run < 1 ||
      run > kMaxChunks * kWarp || (kDrop && p.seed == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_runs = runs::count(n_slots, run);
  const Ws w = ws_of(ws, n_runs);
  const unsigned grid = static_cast<unsigned>(
      (n_runs * kWarp + kWarpBlock - 1) / kWarpBlock);
  cudaError_t err = cudaSuccess;
  const int chunks = (run + kWarp - 1) / kWarp;
  const auto go = [&](auto kc) {
    launch_grids<kK, kMasked, kDrop, decltype(kc)::value>(
        ptr, p, w, n_rows, n_edges, n_slots, n_runs, run, grid, stream, err);
  };
  if (chunks <= 1) {
    go(std::integral_constant<int, 1>{});
  } else if (chunks <= 2) {
    go(std::integral_constant<int, 2>{});
  } else if (chunks <= 4) {
    go(std::integral_constant<int, 4>{});
  } else if (chunks <= 8) {
    go(std::integral_constant<int, 8>{});
  } else {
    go(std::integral_constant<int, kMaxChunks>{});
  }
  return static_cast<int>(err);
}

// The row broadcast of seg_expand_f32: out[e] = v[row of e] for the edges,
// 0 for the pads.  A warp a run of `run` slots: the run's first row by the
// warp-wide search, then 32 consecutive slots a round, each lane stepping
// its row from the round's first past the rows that end at or before its
// slot (empty rows included), and the last lane's row handed on.
__global__ void __launch_bounds__(kWarpBlock)
expand_kernel(const int* __restrict__ ptr, const float* __restrict__ v,
              float* __restrict__ out, int n_rows, int n_edges, int n_slots,
              int64_t n_runs, int run) {
  const int lane = threadIdx.x % kWarp;
  const int64_t k = static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp) +
                    threadIdx.x / kWarp;
  if (k >= n_runs) return;
  const int64_t lo = k * run;
  const int64_t hi = min(lo + run, static_cast<int64_t>(n_slots));
  int row = lo < n_edges
                ? runs::warp_row_of(ptr, n_rows, static_cast<int>(lo), lane)
                : 0;
  for (int64_t b = lo; b < hi; b += kWarp) {
    const int64_t e = b + lane;
    int r = row;
    if (e < n_edges) {
      while (__ldg(ptr + r + 1) <= e) ++r;
      out[e] = __ldg(v + r);
    } else if (e < hi) {
      out[e] = 0.0f;
    }
    row = __shfl_sync(kFull, r, kWarp - 1);
  }
}

}  // namespace seg_softmax

// Launch on `stream`; neither synchronises.  ptr [n_rows + 1] int32 with
// n_edges = ptr[n_rows]; per-edge arrays [n_slots] float32 (the mask
// uint8, or null for none) with n_slots >= n_edges; lse [n_rows]; ws
// [9 n_runs] float32 (softmax.py's ws_floats) with n_runs = max(1,
// ceil(n_slots / run)), run in [1, 512].  Grid 1 writes every field of ws
// that grid 2 reads, so a workspace may serve any number of calls ordered
// on one stream.  Dropout: `seed` a device pointer to one int32, `scale`
// the kept slots' factor 1/(1-rate) in float32; a null seed means none.
// Each returns cudaGetLastError() after its two grids (0 = launched).

// att and lse, and with a seed att_k = att k (att_k [n_slots]).
extern "C" int seg_softmax_fwd_f32(const int* ptr, const float* logits,
                                   const uint8_t* mask, float* att,
                                   float* att_k, float* lse, float* ws,
                                   const int* seed, float rate, float scale,
                                   int n_rows, int n_edges, int n_slots,
                                   int run, cudaStream_t stream) {
  using seg_softmax::Kind;
  using seg_softmax::launch;
  const seg_softmax::Args p{logits, nullptr, mask, att, att_k, lse,
                            seed, rate, scale, 0u};
  if (seed != nullptr && att_k == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mask != nullptr) {
    return seed != nullptr
               ? launch<Kind::kFwd, true, true>(ptr, p, ws, n_rows, n_edges,
                                                n_slots, run, stream)
               : launch<Kind::kFwd, true, false>(ptr, p, ws, n_rows, n_edges,
                                                 n_slots, run, stream);
  }
  return seed != nullptr
             ? launch<Kind::kFwd, false, true>(ptr, p, ws, n_rows, n_edges,
                                               n_slots, run, stream)
             : launch<Kind::kFwd, false, false>(ptr, p, ws, n_rows, n_edges,
                                                n_slots, run, stream);
}

// dl from att and g; with a seed g is the cotangent of att_k, scaled by k
// a slot before the row sums.
extern "C" int seg_softmax_bwd_f32(const int* ptr, const float* att,
                                   const float* g, float* dl, float* ws,
                                   const int* seed, float rate, float scale,
                                   int n_rows, int n_edges, int n_slots,
                                   int run, cudaStream_t stream) {
  using seg_softmax::Kind;
  using seg_softmax::launch;
  const seg_softmax::Args p{att, g, nullptr, dl, nullptr, nullptr,
                            seed, rate, scale, 0u};
  return seed != nullptr
             ? launch<Kind::kBwd, false, true>(ptr, p, ws, n_rows, n_edges,
                                               n_slots, run, stream)
             : launch<Kind::kBwd, false, false>(ptr, p, ws, n_rows, n_edges,
                                                n_slots, run, stream);
}

// The row broadcast out[e] = v[r] for each edge e of row r, 0 on the pads
// [n_edges, n_slots): v [n_rows], out [n_slots], one grid of warps over
// runs of `run` slots (run >= 1); no workspace.  Returns
// cudaGetLastError() after its grid (0 = launched).
extern "C" int seg_expand_f32(const int* ptr, const float* v, float* out,
                              int n_rows, int n_edges, int n_slots, int run,
                              cudaStream_t stream) {
  using seg_softmax::kWarp;
  using seg_softmax::kWarpBlock;
  if (n_rows <= 0 || n_edges < 0 || n_slots < n_edges || run < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_runs = runs::count(n_slots, run);
  constexpr int kWarps = kWarpBlock / kWarp;
  seg_softmax::expand_kernel<<<
      static_cast<unsigned>((n_runs + kWarps - 1) / kWarps), kWarpBlock, 0,
      stream>>>(ptr, v, out, n_rows, n_edges, n_slots, n_runs, run);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* seg_softmax_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
