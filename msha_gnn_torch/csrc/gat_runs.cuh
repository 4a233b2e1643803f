// The GAT kernels on the edge-run schedule (runs.cuh) with the warp split
// into groups of kG lanes, one edge a group: the forward walk of
// gat_fwd.cuh (r1l_fwd_f32, r1_fwd_f32, flash_fwd_f32) and flash_bwd_f32
// (flash_gat.cu).
//
// A group's lanes hold a row's features in registers (as float, whether
// the row is stored in float or, for the bfloat16 payload, in
// __nv_bfloat16): lane li of the group holds kPer floats, in chunks of
// kVec consecutive features, chunk i at
// feature base + (i kG + li) kVec, so one load instruction of the group
// reads kG kVec consecutive floats.  A tile is the kG kPer features one
// group holds; a width d above it takes several tiles.
//
// The online softmax of a row piece is kept per group: (m, s, acc[kPer]),
// the running max, the sum of the undropped p and this lane's features of
// sum p k x[j].  fold adds a step of edges to it, merge_groups merges the
// groups' states by shuffles in a fixed order (group 0 with group 1, then
// with the merged 2 and 3, ...), and merge is the online-softmax merge of
// two pieces, which the fix-up grids also use to add up the pieces of a
// row that crosses runs.  A piece with no edge is (kNeg, 0, 0) and merges
// without NaN: exp(kNeg - kNeg) = 1 multiplies a zero sum.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "gat_common.cuh"
#include "runs.cuh"

namespace gat_runs {

using gat::kFull;
using gat::kNeg;
using gat::kWarp;

// The sum over the kG lanes of a group (a power of two dividing 32): a
// butterfly, so every lane of the group gets the same bits.
template <int kG>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = kG / 2; o > 0; o /= 2) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Where a lane's features lie (see the top of the file).
template <int kG, int kPer>
struct Layout {
  static constexpr int kVec = kPer < 4 ? kPer : 4;
  static constexpr int kChunks = kPer / kVec;
  static constexpr int kTile = kG * kPer;
  // edges a group takes a step: about 16 floats of x a lane in flight
  static constexpr int kSteps = kPer >= 16 ? 1 : 16 / kPer;

  __device__ static __forceinline__ int feature(int li, int i, int base) {
    return base + (i * kG + li) * kVec;
  }
};

// The lane's features of the tile at `base` of the row at p (d values of
// type T, float or __nv_bfloat16; d % kVec == 0, p aligned to kVec values);
// 0 past d.
template <int kG, int kPer, typename T>
__device__ __forceinline__ void load_lane(const T* __restrict__ p, int base,
                                          int d, int li, float (&v)[kPer]) {
  using L = Layout<kG, kPer>;
#pragma unroll
  for (int i = 0; i < L::kChunks; ++i) {
    const int f = L::feature(li, i, base);
    float chunk[L::kVec];
    if (f < d) {
      runs::ldg_vec<L::kVec>(p + f, chunk);
    } else {
#pragma unroll
      for (int u = 0; u < L::kVec; ++u) chunk[u] = 0.0f;
    }
#pragma unroll
    for (int u = 0; u < L::kVec; ++u) v[i * L::kVec + u] = chunk[u];
  }
}

// The lane's features of the tile at `base` stored to the row at p.
template <int kG, int kPer>
__device__ __forceinline__ void store_lane(float* __restrict__ p, int base,
                                           int d, int li,
                                           const float (&v)[kPer]) {
  using L = Layout<kG, kPer>;
#pragma unroll
  for (int i = 0; i < L::kChunks; ++i) {
    const int f = L::feature(li, i, base);
    if (f < d) {
      float chunk[L::kVec];
#pragma unroll
      for (int u = 0; u < L::kVec; ++u) chunk[u] = v[i * L::kVec + u];
      runs::store_vec<L::kVec>(p + f, chunk);
    }
  }
}

// The lane's part of the dot <p, q> of two d-float rows, of which it
// holds its features of the tile at `base` in pv and qv: the tiles in
// order, the others loaded, so every tile's block forms the same bits.
// group_sum of it is the dot.
template <int kG, int kPer, typename TP, typename TQ>
__device__ __forceinline__ float lane_dot(const float (&pv)[kPer],
                                          const float (&qv)[kPer],
                                          const TP* __restrict__ p,
                                          const TQ* __restrict__ q,
                                          int base, int d, int li) {
  using L = Layout<kG, kPer>;
  float v = 0.0f;
  if (L::kTile >= d) {  // one tile: the registers
#pragma unroll
    for (int i = 0; i < kPer; ++i) v = fmaf(pv[i], qv[i], v);
    return v;
  }
  for (int tb = 0; tb < d; tb += L::kTile) {
    if (tb == base) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) v = fmaf(pv[i], qv[i], v);
    } else {
      float pt[kPer];
      float qt[kPer];
      load_lane<kG, kPer>(p, tb, d, li, pt);
      load_lane<kG, kPer>(q, tb, d, li, qt);
#pragma unroll
      for (int i = 0; i < kPer; ++i) v = fmaf(pt[i], qt[i], v);
    }
  }
  return v;
}

// The columns of a step at eb of the piece that ends at pe: edge eb + u
// kGroups + grp of group grp, 0 past pe.
template <int kSteps, int kGroups>
__device__ __forceinline__ void load_step(const int* __restrict__ col, int eb,
                                          int pe, int grp,
                                          int (&j)[kSteps]) {
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const int e = eb + u * kGroups + grp;
    j[u] = e < pe ? __ldg(col + e) : 0;
  }
}

// The online-softmax state of one row piece, as a group holds it.
template <int kPer>
struct Piece {
  float m;
  float s;
  float acc[kPer];

  __device__ __forceinline__ void reset() {
    m = kNeg;
    s = 0.0f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] = 0.0f;
  }
};

// Adds a step of kSteps edges to a group's piece: l[u] the logits, w[u]
// the keep scales, xv[u] the lane's features of x[j_u]; absent edges
// (ok[u] false) have xv 0 and add nothing.
template <int kSteps, int kPer>
__device__ __forceinline__ void fold(Piece<kPer>& st,
                                     const float (&l)[kSteps],
                                     const float (&keep)[kSteps],
                                     const bool (&ok)[kSteps],
                                     const float (&xv)[kSteps][kPer]) {
  float m_new = st.m;
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    if (ok[u]) m_new = fmaxf(m_new, l[u]);
  }
  const float rescale = expf(st.m - m_new);
  float w[kSteps];
  float p_sum = 0.0f;
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const float p = ok[u] ? expf(l[u] - m_new) : 0.0f;
    p_sum += p;
    w[u] = p * keep[u];
  }
  st.s = st.s * rescale + p_sum;
  st.m = m_new;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    float v = st.acc[i] * rescale;
#pragma unroll
    for (int u = 0; u < kSteps; ++u) v = fmaf(w[u], xv[u][i], v);
    st.acc[i] = v;
  }
}

// The online-softmax merge of a piece (m2, s2) into (m, s): the factors
// that scale the two pieces' acc (acc = acc r1 + acc2 r2).
__device__ __forceinline__ void merge(float& m, float& s, float m2, float s2,
                                      float& r1, float& r2) {
  const float m_new = fmaxf(m, m2);
  r1 = expf(m - m_new);
  r2 = expf(m2 - m_new);
  s = fmaf(s2, r2, s * r1);
  m = m_new;
}

// Merges the groups' pieces by shuffles: round o merges the state of the
// groups o apart, so group 0 ends with ((0 + 1) + (2 + 3)) + ...  Every
// lane of the warp calls it; group 0's lanes hold the row piece after.
template <int kG, int kPer>
__device__ __forceinline__ void merge_groups(Piece<kPer>& st) {
#pragma unroll
  for (int o = kG; o < kWarp; o *= 2) {
    const float m2 = __shfl_xor_sync(kFull, st.m, o);
    const float s2 = __shfl_xor_sync(kFull, st.s, o);
    float r1;
    float r2;
    merge(st.m, st.s, m2, s2, r1, r2);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float a2 = __shfl_xor_sync(kFull, st.acc[i], o);
      st.acc[i] = fmaf(a2, r2, st.acc[i] * r1);
    }
  }
}

// The floats a lane holds (1, 2, 4 or 8) for a group of g lanes at width
// d: the fewest whose tile covers d, in vectors that d and the alignment
// `at` of the rows allow (4 floats need d % 4 == 0 and 16-byte rows, 2
// need d % 2 == 0 and 8-byte rows; a bfloat16 row enters `at` through
// runs::float_at); the most that are allowed when no tile covers d.
inline int per_lane(int g, int d, uintptr_t at) {
  const int max_vec = (d % 4 == 0 && at % 16 == 0)  ? 4
                      : (d % 2 == 0 && at % 8 == 0) ? 2
                                                    : 1;
  const int max_per = max_vec == 4 ? 8 : max_vec;
  for (int per = 1; per < max_per; per *= 2) {
    if (g * per >= d) return per;
  }
  return max_per;
}

}  // namespace gat_runs
