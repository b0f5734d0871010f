// Pieces shared by the list-row scan kernels (grouped_scan.cu, K1;
// grouped_pq_scan.cu, K2; full_row_scan.cu, K3 and K4), which replace the
// TPU kernels of cuda_acceleratedvectordatabaseengine_tpu/ops/
// pallas_scan.py: CTA shape, shared-memory layout helpers, widening loads,
// the distance of a dot, the warp-level running top-k (warp_merge), and the
// CUDA-core path of K1 and K3 on fp32 arenas (query and slot-tile staging,
// fp32 tile dots).
//
// These kernels give one CTA to one list-row (up to M queries that probe the
// same list). K1 and K2 keep each query's k best (distance, slot) pairs
// spread over the lanes of one warp, ties going to the smaller slot; K3
// writes full rows.
//
// The fp32 tile dots here were K1's and K3's only dot loop until their
// tensor-core engine (tc_scan.cuh) took over int8 and bf16 arenas, the main
// path. Builds of K1 with parts of this loop's kernel edited out, timed at
// the IVF-Flat main shape on an NVIDIA H100 80GB HBM3 at 700 W, showed this
// loop's issue rate as what held both kernels at 17 ms: 16.9 ms with the
// tile staging skipped, 2.5 ms with the dots skipped. It stays for fp32
// arenas, whose values bf16 does not hold exactly. Where the flat scans are
// bound now: tc_scan.cuh (HBM bytes, 0.245 ms for K1 and 0.30 ms for K3 at
// the main shape).

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

// Arena element types of the flat scans (K1, K3, K4), as the wrappers name
// them.
enum DtypeId { kInt8 = 0, kBf16 = 1, kF32 = 2 };

__host__ inline int elem_size(int dtype) {
  return dtype == kInt8 ? 1 : (dtype == kBf16 ? 2 : 4);
}

// Slots per lane of a flat tile: 64-slot tiles for int8 / bf16, 32 for fp32.
__host__ inline int slots_per_lane(int dtype) { return dtype == kF32 ? 1 : 2; }

// Shared memory of a flat list-row CTA (K1, K3): M queries and one tile.
__host__ inline size_t flat_row_smem_bytes(int m, int dim, int dtype) {
  return query_smem_bytes(m, dim) +
         tile_smem_bytes(dim, elem_size(dtype), 32 * slots_per_lane(dtype));
}

// Widest list-row (at most 64) whose queries and tile fit one CTA.
__host__ inline int flat_row_max_m(int dim, int dtype) {
  if (dim <= 0 || dtype < kInt8 || dtype > kF32) return 0;
  int m = 0;
  while (m < 64 && flat_row_smem_bytes(m + 1, dim, dtype) <= kSmemLimit) ++m;
  return m;
}

// Load a list-row's queries into shared memory: qi[mm] = qrow[mm] (an index
// into the row's pair space, -1 = empty slot), qs[mm] = q[qi[mm] / qdiv]
// zero-padded to dp columns; zero the tile's pad columns once. Ends with
// __syncthreads().
template <typename T>
__device__ __forceinline__ void load_row_queries(
    float* qs, int* qi, T* tile, const float* __restrict__ q,
    const int* __restrict__ qrow, int m, int dim, int qdiv, int ts) {
  const int tid = threadIdx.x;
  const int dp = padded_dim(dim);
  for (int i = tid; i < m; i += kThreads) qi[i] = qrow[i];
  __syncthreads();
  for (int e = tid; e < m * dp; e += kThreads) {
    const int mm = e / dp;
    const int d = e - mm * dp;
    const int b = qi[mm] >= 0 ? qi[mm] / qdiv : -1;
    qs[e] = (b >= 0 && d < dim) ? q[static_cast<size_t>(b) * dim + d] : 0.f;
  }
  if (dp != dim) {  // zero the pad columns of the tile once
    const int pw = dp - dim;
    const int tstride = dp + 4;
    for (int e = tid; e < ts * pw; e += kThreads) {
      tile[(e / pw) * tstride + dim + e % pw] = Vec4<T>::zero();
    }
  }
  __syncthreads();
}

// |q|^2 and q . anchor of each loaded query (warp w takes queries w, w+8,
// ...); published by the caller's next __syncthreads().
__device__ __forceinline__ void row_query_norms(const float* qs, float* qsq,
                                                float* qa, const float* anc,
                                                int m, int dim) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int dp = padded_dim(dim);
  for (int mm = warp; mm < m; mm += kWarps) {
    float s = 0.f;
    float a = 0.f;
    for (int d = lane; d < dim; d += 32) {
      const float v = qs[mm * dp + d];
      s = fmaf(v, v, s);
      if (anc != nullptr) a = fmaf(v, anc[d], a);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(kFull, s, off);
      a += __shfl_xor_sync(kFull, a, off);
    }
    if (lane == 0) {
      qsq[mm] = s;
      qa[mm] = a;
    }
  }
}

// Copy slots [s0, s0 + nt) of one list (rows of dim elements from lbase)
// into the tile (row stride dim + pad + 4 elements), with coalesced 16-byte
// loads when vec16. The caller brackets it with __syncthreads().
template <typename T>
__device__ __forceinline__ void stage_tile(T* tile, const T* lbase, int s0,
                                           int nt, int dim, bool vec16) {
  const int tid = threadIdx.x;
  const int tstride = padded_dim(dim) + 4;
  const size_t row_bytes = static_cast<size_t>(dim) * sizeof(T);
  if (vec16) {
    const int per_row = static_cast<int>(row_bytes / 16);
    const int tstride_bytes = tstride * static_cast<int>(sizeof(T));
    const uint4* src =
        reinterpret_cast<const uint4*>(lbase + static_cast<size_t>(s0) * dim);
    unsigned char* dst = reinterpret_cast<unsigned char*>(tile);
    for (int c = tid; c < nt * per_row; c += kThreads) {
      const int r = c / per_row;
      const uint4 v = __ldg(src + c);
      uint32_t* o = reinterpret_cast<uint32_t*>(dst + r * tstride_bytes +
                                                (c - r * per_row) * 16);
      o[0] = v.x;
      o[1] = v.y;
      o[2] = v.z;
      o[3] = v.w;
    }
  } else {
    const T* src = lbase + static_cast<size_t>(s0) * dim;
    for (int e = tid; e < nt * dim; e += kThreads) {
      const int r = e / dim;
      tile[r * tstride + (e - r * dim)] = src[e];
    }
  }
}

// fp32 dots of a warp's queries with the staged tile: acc[i][j] is the dot
// of query warp + 8 i (for i < nq) with tile slot lane + 32 j. Tile values
// are widened exactly; the query stays fp32.
template <typename T, int MPT, int SPL>
__device__ __forceinline__ void tile_dots(float (&acc)[MPT][SPL],
                                          const T* tile, const float* qs,
                                          int dim, int nq) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int dp = padded_dim(dim);
  const int tstride = dp + 4;
#pragma unroll
  for (int i = 0; i < MPT; ++i)
#pragma unroll
    for (int j = 0; j < SPL; ++j) acc[i][j] = 0.f;
  for (int d = 0; d < dp; d += 4) {
    float4 xv[SPL];
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      xv[j] = Vec4<T>::load(tile + (lane + 32 * j) * tstride + d);
    }
#pragma unroll
    for (int i = 0; i < MPT; ++i) {
      if (i < nq) {
        const float4 qv = *reinterpret_cast<const float4*>(
            qs + (warp + kWarps * i) * dp + d);
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          acc[i][j] = fmaf(qv.x, xv[j].x, acc[i][j]);
          acc[i][j] = fmaf(qv.y, xv[j].y, acc[i][j]);
          acc[i][j] = fmaf(qv.z, xv[j].z, acc[i][j]);
          acc[i][j] = fmaf(qv.w, xv[j].w, acc[i][j]);
        }
      }
    }
  }
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
