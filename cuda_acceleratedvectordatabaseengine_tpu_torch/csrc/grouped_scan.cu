// Grouped probed-list scan with a fused per-(query, list) top-k, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel K1,
// cuda_acceleratedvectordatabaseengine_tpu/ops/pallas_scan.py::
// scan_probed_lists_pallas_grouped (kernel body _grouped_kernel, row top-k
// _emit_row_topk / _emit_row_topk_t4). The torch wrapper is
// cuda_acceleratedvectordatabaseengine_tpu_torch/ops/grouped_scan.py, which
// also holds the plain PyTorch version of the same function.
//
// What it computes. The (query, probed list) pairs of a batch are packed by
// the wrapper into list-rows of at most M queries that probe the same list.
// One CTA handles one list-row: for each of its queries and each occupied
// slot s < min(count_l, cap_s) of list l it forms
//     qx = scale[l,s] * (q . code[l,s]) + q . anchor[l]
// (scale 1 and anchor 0 when absent) and the distance
//     L2: max(|q|^2 - 2 qx + arena_sq[l,s], 0)   IP: -qx   cosine: 1 - qx,
// and keeps the k smallest (distance, slot) pairs per query, ties broken by
// the smaller slot (the order _emit_row_topk produces). Output is
// [n_rows, M, k] distances and slots, +inf / -1 where a list has fewer than
// k rows, for sentinel rows (list id >= nlist) and for empty query slots.
//
// Design. The CTA loads its own list id and query indices and reads its M
// query rows straight from q [B, D] into shared memory (no pre-gather), with
// |q|^2 and q . anchor once per query. It then walks the list in tiles of
// TS = 32 * SPL slots: each tile's rows are staged in shared memory in the
// arena dtype with coalesced 16-byte loads, and widened to fp32 in the dot
// loop. Query stays fp32, accumulation is fp32: the exact contract of the
// reference gather scan (no tensor cores, no bf16 rounding of the query in
// this version). Warp w owns queries w, w+8, ...; lane t owns slots t and
// t+32 of the tile, so each warp ends a tile holding the tile's candidate
// distances of its queries in registers. A real cross-lane top-k follows:
// each query's running top-k lives spread over the lanes of its warp (entry
// r at lane r % 32), a tile whose best candidate cannot beat the current
// k-th is skipped with one ballot, and otherwise k rounds of shuffle argmin
// over running + tile candidates rebuild the list.
//
// What bounds it on the H100. Each list-row reads its list's cap_s * D
// arena bytes once (plus norms and scales) and does 2 * M * cap_s * D fp32
// FLOPs on them: arithmetic intensity 2M FLOP per int8 byte, so on paper
// HBM reads bind below ~10 queries per row and the fp32 FMA pipes above.
// Rows of one list are separate CTAs, so a list with several rows is read
// several times (mostly from L2). Measured on an H100 80GB HBM3 at 700 W,
// the kernel reaches neither bound: about 1 TB/s of list reads at 1-4
// queries per row, about 3 TFLOP/s of fp32 at 48 queries per row. What
// limits it has not been measured (no hardware-counter profile yet). The
// candidates: idle warps when a row holds fewer than 8 queries (warp w owns
// queries w, w+8, ...), the shared-memory loads of the dot loop, the
// shuffle rounds of the top-k, and occupancy.
//
// The pieces shared with the K2 and K3 kernels (grouped_pq_scan.cu,
// full_row_scan.cu): shared-memory layout, query and tile staging, the fp32
// tile dots and warp_merge, are in grouped_common.cuh.
//
// What later versions change: wgmma on int8 codes widened to bf16 (exact)
// against a hi/lo bf16 split of the query, which keeps near-fp32 accuracy
// at tensor-core rate; TMA loads into a multi-stage ring with mbarriers; and
// one list tile shared by all rows of the list (a persistent CTA per list),
// so that a list is read from HBM once per batch.

#include "grouped_common.cuh"

#include <cuda_bf16.h>

#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

using namespace vdb;

template <typename T, int MPT, int SPL, int KPL>
__global__ void __launch_bounds__(kThreads)
grouped_scan_kernel(const float* __restrict__ q, const T* __restrict__ arena,
                    const float* __restrict__ arena_sq,
                    const float* __restrict__ scale,
                    const float* __restrict__ anchors,
                    const int* __restrict__ counts,
                    const int* __restrict__ row_list,
                    const int* __restrict__ qrow_table,
                    float* __restrict__ out_d, int* __restrict__ out_s, int m,
                    int dim, int nlist, int cap, int cap_s, int k,
                    int metric) {
  constexpr int TS = 32 * SPL;
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int dp = padded_dim(dim);

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [m][dp]
  float* qsq = qs + static_cast<size_t>(m) * dp;
  float* qa = qsq + m;
  int* qi = reinterpret_cast<int*>(qa + m);
  T* tile = reinterpret_cast<T*>(smem + query_smem_bytes(m, dim));

  float* od = out_d + static_cast<size_t>(row) * m * k;
  int* os = out_s + static_cast<size_t>(row) * m * k;
  const int list = row_list[row];
  if (list < 0 || list >= nlist) {  // sentinel row: nothing to scan
    for (int i = tid; i < m * k; i += kThreads) {
      od[i] = INFINITY;
      os[i] = -1;
    }
    return;
  }

  // --- this row's queries, straight from q [B, D] --------------------------
  load_row_queries(qs, qi, tile, q, qrow_table + static_cast<size_t>(row) * m,
                   m, dim, 1, TS);
  row_query_norms(qs, qsq, qa,
                  anchors != nullptr ? anchors + static_cast<size_t>(list) * dim
                                     : nullptr,
                  m, dim);
  // (the first tile's __syncthreads publishes qsq / qa)

  // --- walk the occupied slot prefix in tiles of TS slots ------------------
  const int lim = min(counts[list], cap_s);
  const T* lbase = arena + static_cast<size_t>(list) * cap * dim;
  const float* sq_l = arena_sq + static_cast<size_t>(list) * cap;
  const float* sc_l =
      scale != nullptr ? scale + static_cast<size_t>(list) * cap : nullptr;
  const int nq = (m - warp + kWarps - 1) / kWarps;  // queries of this warp
  const bool vec16 = (static_cast<size_t>(dim) * sizeof(T) % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(arena) % 16 == 0);

  float bd[MPT][KPL];
  int bs[MPT][KPL];
  float kth[MPT];
#pragma unroll
  for (int i = 0; i < MPT; ++i) {
    kth[i] = INFINITY;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      bd[i][j] = INFINITY;
      bs[i][j] = INT_MAX;
    }
  }

  for (int s0 = 0; s0 < lim; s0 += TS) {
    const int nt = min(TS, lim - s0);
    __syncthreads();  // the previous tile is consumed
    stage_tile(tile, lbase, s0, nt, dim, vec16);
    __syncthreads();

    float acc[MPT][SPL];
    tile_dots<T, MPT, SPL>(acc, tile, qs, dim, nq);

    float xsq[SPL];
    float sc[SPL];
    bool valid[SPL];
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      const int t = lane + 32 * j;
      valid[j] = t < nt;
      xsq[j] = valid[j] ? sq_l[s0 + t] : 0.f;
      sc[j] = (valid[j] && sc_l != nullptr) ? sc_l[s0 + t] : 1.f;
    }
#pragma unroll
    for (int i = 0; i < MPT; ++i) {
      if (i < nq) {
        const int mm = warp + kWarps * i;
        float cd[SPL];
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          const float qx = acc[i][j] * sc[j] + qa[mm];
          cd[j] = valid[j] ? flat_distance(metric, qx, qsq[mm], xsq[j])
                           : INFINITY;
        }
        warp_merge<SPL, KPL>(bd[i], bs[i], kth[i], cd, s0 + lane, k);
      }
    }
  }

  // --- write the per-query top-k -------------------------------------------
  __syncthreads();  // qi / qsq visible even when the list is empty
#pragma unroll
  for (int i = 0; i < MPT; ++i) {
    if (i < nq) {
      const int mm = warp + kWarps * i;
      const bool live = qi[mm] >= 0;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int r = lane + 32 * j;
        if (r < k) {
          const bool hit = live && bd[i][j] != INFINITY;
          od[mm * k + r] = hit ? bd[i][j] : INFINITY;
          os[mm * k + r] = hit ? bs[i][j] : -1;
        }
      }
    }
  }
}

template <typename T, int MPT, int SPL, int KPL>
cudaError_t launch(const float* q, const void* arena, const float* arena_sq,
                   const float* scale, const float* anchors, const int* counts,
                   const int* row_list, const int* qrow_table, float* out_d,
                   int* out_s, int n_rows, int m, int dim, int nlist, int cap,
                   int cap_s, int k, int metric, int dtype,
                   cudaStream_t stream) {
  auto kernel = grouped_scan_kernel<T, MPT, SPL, KPL>;
  const size_t smem = flat_row_smem_bytes(m, dim, dtype);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<n_rows, kThreads, smem, stream>>>(
      q, static_cast<const T*>(arena), arena_sq, scale, anchors, counts,
      row_list, qrow_table, out_d, out_s, m, dim, nlist, cap, cap_s, k,
      metric);
  return cudaGetLastError();
}

template <typename T, int SPL, int KPL>
cudaError_t dispatch_m(int mpt, const float* q, const void* arena,
                       const float* arena_sq, const float* scale,
                       const float* anchors, const int* counts,
                       const int* row_list, const int* qrow_table,
                       float* out_d, int* out_s, int n_rows, int m, int dim,
                       int nlist, int cap, int cap_s, int k, int metric,
                       int dtype, cudaStream_t stream) {
#define VDB_LAUNCH(MPT)                                                      \
  return launch<T, MPT, SPL, KPL>(q, arena, arena_sq, scale, anchors, counts, \
                                  row_list, qrow_table, out_d, out_s, n_rows, \
                                  m, dim, nlist, cap, cap_s, k, metric, dtype, \
                                  stream)
  if (mpt <= 1) VDB_LAUNCH(1);
  if (mpt <= 2) VDB_LAUNCH(2);
  if (mpt <= 4) VDB_LAUNCH(4);
  VDB_LAUNCH(8);
#undef VDB_LAUNCH
}

template <typename T, int SPL>
cudaError_t dispatch_k(int mpt, const float* q, const void* arena,
                       const float* arena_sq, const float* scale,
                       const float* anchors, const int* counts,
                       const int* row_list, const int* qrow_table,
                       float* out_d, int* out_s, int n_rows, int m, int dim,
                       int nlist, int cap, int cap_s, int k, int metric,
                       int dtype, cudaStream_t stream) {
  if (k <= 32) {
    return dispatch_m<T, SPL, 1>(mpt, q, arena, arena_sq, scale, anchors,
                                 counts, row_list, qrow_table, out_d, out_s,
                                 n_rows, m, dim, nlist, cap, cap_s, k, metric,
                                 dtype, stream);
  }
  return dispatch_m<T, SPL, 2>(mpt, q, arena, arena_sq, scale, anchors, counts,
                               row_list, qrow_table, out_d, out_s, n_rows, m,
                               dim, nlist, cap, cap_s, k, metric, dtype,
                               stream);
}

}  // namespace

extern "C" {

// Largest list-row width M whose queries and slot tile fit the shared memory
// of one CTA at this dimension and arena dtype (0: none fits).
int vdb_grouped_scan_max_m(int dim, int dtype) {
  return flat_row_max_m(dim, dtype);
}

// Launch the grouped scan on `stream`. Returns a cudaError_t (0 = launched).
// Pointers: q [B, dim] f32; arena [nlist, cap, dim] of `dtype` (0 int8,
// 1 bf16, 2 f32); arena_sq [nlist, cap] f32; scale [nlist, cap] f32 or null;
// anchors [nlist, dim] f32 or null; counts [nlist] i32; row_list [n_rows]
// i32; qrow_table [n_rows, m] i32; out_d / out_s [n_rows, m, k].
int vdb_grouped_scan(const void* q, const void* arena, const void* arena_sq,
                     const void* scale, const void* anchors,
                     const void* counts, const void* row_list,
                     const void* qrow_table, void* out_d, void* out_s,
                     int n_rows, int m, int dim, int nlist, int cap, int cap_s,
                     int k, int metric, int dtype, void* stream) {
  if (n_rows <= 0 || m <= 0 || m > vdb_grouped_scan_max_m(dim, dtype) ||
      k <= 0 || k > 64 || cap_s <= 0 || cap_s > cap || nlist <= 0 ||
      metric < kL2 || metric > kCosine) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int mpt = (m + kWarps - 1) / kWarps;
  const float* qf = static_cast<const float*>(q);
  const float* sq = static_cast<const float*>(arena_sq);
  const float* sc = static_cast<const float*>(scale);
  const float* an = static_cast<const float*>(anchors);
  const int* cn = static_cast<const int*>(counts);
  const int* rl = static_cast<const int*>(row_list);
  const int* qt = static_cast<const int*>(qrow_table);
  float* od = static_cast<float*>(out_d);
  int* os = static_cast<int*>(out_s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kInt8:
      err = dispatch_k<int8_t, 2>(mpt, qf, arena, sq, sc, an, cn, rl, qt, od,
                                  os, n_rows, m, dim, nlist, cap, cap_s, k,
                                  metric, dtype, st);
      break;
    case kBf16:
      err = dispatch_k<__nv_bfloat16, 2>(mpt, qf, arena, sq, sc, an, cn, rl,
                                         qt, od, os, n_rows, m, dim, nlist,
                                         cap, cap_s, k, metric, dtype, st);
      break;
    default:
      err = dispatch_k<float, 1>(mpt, qf, arena, sq, sc, an, cn, rl, qt, od,
                                 os, n_rows, m, dim, nlist, cap, cap_s, k,
                                 metric, dtype, st);
      break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
