// Pieces shared by the grouped scan kernels (grouped_scan.cu, K1, and
// grouped_pq_scan.cu, K2): CTA shape, shared-memory layout helpers, widening
// loads from a staged tile, and the warp-level running top-k.
//
// Both kernels give one CTA to one list-row (up to M queries that probe the
// same list), stage M query rows and a tile of slots in shared memory, and
// keep each query's k best (distance, slot) pairs spread over the lanes of
// one warp, ties going to the smaller slot.

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

// Four consecutive tile elements in shared memory, widened to fp32.
template <typename T>
struct Vec4;

template <>
struct Vec4<int8_t> {
  static __device__ __forceinline__ float4 load(const int8_t* p) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    return make_float4(c.x, c.y, c.z, c.w);
  }
  static __device__ __forceinline__ int8_t zero() { return 0; }
};

template <>
struct Vec4<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    // bf16 -> fp32 is exact: the bf16 bits are the high half of the fp32.
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  }
  static __device__ __forceinline__ __nv_bfloat16 zero() {
    return __ushort_as_bfloat16(0);
  }
};

template <>
struct Vec4<float> {
  static __device__ __forceinline__ float4 load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ float zero() { return 0.f; }
};

__host__ __device__ inline int padded_dim(int dim) { return (dim + 3) & ~3; }

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

// Shared memory: queries [m][dp] fp32, |q|^2 [m], q.anchor [m], query
// index [m], then the slot tile [TS][dp + 4]. The +4 element row pad puts
// the 32 rows a warp reads at one column in distinct banks.
__host__ __device__ inline size_t query_smem_bytes(int m, int dim) {
  return align16(sizeof(float) * (static_cast<size_t>(m) * padded_dim(dim) +
                                  3 * static_cast<size_t>(m)));
}

__host__ __device__ inline size_t tile_smem_bytes(int dim, int elem, int ts) {
  return static_cast<size_t>(ts) * (padded_dim(dim) + 4) * elem;
}

__device__ __forceinline__ bool lex_less(float ad, int as, float bd, int bs) {
  return ad < bd || (ad == bd && as < bs);
}

// Merge one tile's candidates into a query's running top-k, held by one
// warp: entry r of the sorted list lives at lane r % 32, register r / 32.
// Candidates are (distance, slot) pairs ordered lexicographically; slots
// are unique, so the lane that owns the warp-wide minimum is the one whose
// local minimum carries that slot.
template <int SPL, int KPL>
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
    ls[KPL + j] = in ? slot0 + 32 * j : INT_MAX;
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
