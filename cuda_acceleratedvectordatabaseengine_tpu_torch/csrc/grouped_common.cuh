// Pieces shared by the list-row scan kernels (grouped_scan.cu, K1;
// grouped_pq_scan.cu, K2; full_row_scan.cu, K3 and K4), which replace the
// TPU kernels of cuda_acceleratedvectordatabaseengine_tpu/ops/
// pallas_scan.py: CTA shape, shared-memory helpers, the arena dtype ids, the
// distance of a dot and the warp-level running top-k (warp_merge).
//
// These kernels give one CTA to one list-row (up to M queries that probe the
// same list). K1 and K2 keep each query's k best (distance, slot) pairs
// spread over the lanes of one warp, ties going to the smaller slot; K3
// writes full rows. K1's and K3's dots run on the tensor-core engine
// (tc_scan.cuh) on every arena dtype; the fp32 CUDA-core dot loop they
// shared before it (fp32 query rows and slot tiles staged here, bound by
// its issue rate at 17 ms on int8 and 32 ms on fp32 for K1 at the main
// shape, NVIDIA H100 80GB HBM3, 700 W) is gone.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace vdb {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemLimit = 232448;  // 227 KB opt-in dynamic shared memory

enum MetricId { kL2 = 0, kIP = 1, kCosine = 2 };

__host__ __device__ inline int padded_dim(int dim) { return (dim + 3) & ~3; }

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Arena element types of the flat scans (K1, K3, K4), as the wrappers name
// them.
enum DtypeId { kInt8 = 0, kBf16 = 1, kF32 = 2 };

__host__ inline int elem_size(int dtype) {
  return dtype == kInt8 ? 1 : (dtype == kBf16 ? 2 : 4);
}

// Distance from qx = q . x (scale and anchor applied), |q|^2 and |x|^2.
__device__ __forceinline__ float flat_distance(int metric, float qx, float qsq,
                                               float xsq) {
  if (metric == kL2) return fmaxf(qsq - 2.f * qx + xsq, 0.f);
  if (metric == kIP) return -qx;
  return 1.f - qx;
}

__device__ __forceinline__ bool lex_less(float ad, int as, float bd, int bs) {
  return ad < bd || (ad == bd && as < bs);
}

// Merge one tile's candidates into a query's running top-k, held by one
// warp: entry r of the sorted list lives at lane r % 32, register r / 32.
// Candidates are (distance, slot) pairs ordered lexicographically; slots
// are unique, so the lane that owns the warp-wide minimum is the one whose
// local minimum carries that slot. A lane's candidate j is slot
// slot0 + JSTRIDE j: 32 where a lane owns every 32nd slot of a tile (K1), 1
// where it owns consecutive slots (K2).
template <int SPL, int KPL, int JSTRIDE = 32>
__device__ __forceinline__ void warp_merge(float (&bd)[KPL], int (&bs)[KPL],
                                           float& kth, const float (&cd)[SPL],
                                           int slot0, int k) {
  bool better = false;
#pragma unroll
  for (int j = 0; j < SPL; ++j) better |= cd[j] < kth;
  // A tile slot equal to the k-th distance loses the tie: its slot is
  // larger than every slot already in the list.
  if (!__any_sync(kFull, better)) return;

  constexpr int C = KPL + SPL;
  float ld[C];
  int ls[C];
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    ld[j] = bd[j];
    ls[j] = bs[j];
  }
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    const bool in = cd[j] < kth;
    ld[KPL + j] = in ? cd[j] : INFINITY;
    ls[KPL + j] = in ? slot0 + JSTRIDE * j : INT_MAX;
  }
  float nd[KPL];
  int ns[KPL];
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    nd[j] = INFINITY;
    ns[j] = INT_MAX;
  }
  const int lane = threadIdx.x & 31;
  for (int r = 0; r < k; ++r) {
    float v = INFINITY;
    int s = INT_MAX;
    int w = -1;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (lex_less(ld[c], ls[c], v, s)) {
        v = ld[c];
        s = ls[c];
        w = c;
      }
    }
    float gv = v;
    int gs = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(kFull, gv, off);
      const int os = __shfl_xor_sync(kFull, gs, off);
      if (lex_less(ov, os, gv, gs)) {
        gv = ov;
        gs = os;
      }
    }
    if (gv == INFINITY) break;  // warp-uniform: only empties remain
    if (w >= 0 && s == gs) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c == w) {
          ld[c] = INFINITY;
          ls[c] = INT_MAX;
        }
      }
    }
    if ((r & 31) == lane) {
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        if (j == (r >> 5)) {
          nd[j] = gv;
          ns[j] = gs;
        }
      }
    }
  }
  float t = INFINITY;
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    bd[j] = nd[j];
    bs[j] = ns[j];
    if (j == ((k - 1) >> 5)) t = nd[j];
  }
  kth = __shfl_sync(kFull, t, (k - 1) & 31);
}

}  // namespace vdb
