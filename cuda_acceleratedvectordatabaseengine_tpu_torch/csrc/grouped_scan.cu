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
// Design. The dots run on the tensor cores, on exact bf16 products
// (tc_scan.cuh): the wrapper splits the fp32 queries into three bf16 planes
// [3, B, D] once per call, and grouped_scan_tc_kernel gives one CTA of 10
// warps to one list-row. Warps 8-9 stream the list's tiles of 256 slots, D
// in chunks (64 wide on int8 / bf16 arenas, 32 on fp32), and the row's
// query-plane chunks through a 2-4 stage cp.async ring ordered by
// mbarriers; warps 0-7 multiply them with mma.sync m16n8k16 bf16 (a fresh
// fp32 accumulator per chunk, the chunks summed on the CUDA cores; int8
// widened to bf16 once in registers, fp32 split into three bf16 planes in
// registers and multiplied as six plane products), turn each tile's
// accumulators into distances in shared memory, and keep each query's top-k
// with warp_merge: the running list of query w + 8 i spread over the lanes
// of warp w (entry r at lane r % 32), a tile whose best candidate cannot
// beat the current k-th skipped with one ballot, k rounds of shuffle argmin
// otherwise, ties to the smaller slot. |q|^2 and q . anchor stay fp32 on
// the CUDA cores. The row width is at most 64 at any D and arena dtype (the
// ring holds D chunks), reported by vdb_grouped_scan_max_m.
//
// What bounds it on the H100 (SXM, 700 W). At the IVF-Flat main shape
// (D 768, nlist 1024, cap 1408, B 1024, nprobe 32, k 10) a call must read
// the probed lists once: 0.82 GB of int8 residuals, 0.245 ms at 3.35 TB/s,
// against three bf16 products of 52.5 GFLOP, 0.16 ms at 989 TFLOP/s; 3.2 GB
// on an fp32 arena, 0.96 ms, against six products of 54 GFLOP, 0.33 ms. So
// bytes bound it. The fp32 CUDA-core loop of the first version (fp32 query
// rows and 32-slot tiles in shared memory, one FMA chain per query and slot)
// could never beat 0.78 ms (52.5 GFLOP at 67 TFLOP/s) and was bound by its
// issue rate: 16.9 ms on int8 (16.9 ms with the tile staging skipped, 2.5
// ms with the dots skipped, 2.1 ms with both, 7.2 ms at M 16) and 32.0 ms
// on fp32, timed on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md).
//
// The pieces shared with K3 (full_row_scan.cu): the tensor-core engine in
// tc_scan.cuh; with K2 and K3, the helpers and warp_merge in
// grouped_common.cuh.
//
// What later versions change. The tensor-core kernel takes 1.92 ms at the
// int8 main shape, 7.8x its bound, and 3.07 ms on fp32, 3.2x (NVIDIA H100
// 80GB HBM3, 700 W), in three parts that run one after another
// (tc_scan.cuh): the ring, the mma and the top-k merge. So: merge warps of their own behind a double-buffered distance
// tile, so that one tile's merge overlaps the next tile's mma; wgmma
// instead of mma.sync (the slot tile as the register operand, the planes
// in shared memory); the query planes kept resident where M allows, instead
// of re-read for every tile; and one list tile shared by all rows of a list
// (a persistent CTA per list), so that a list is read from HBM once per
// batch.

#include "grouped_common.cuh"
#include "tc_scan.cuh"

#include <cuda_bf16.h>

#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

using namespace vdb;

// Tensor-core list-row scan with the fused top-k (int8, bf16, fp32 arenas).
template <typename T, int KPL>
__global__ void __launch_bounds__(tc::kThreads, 1)
grouped_scan_tc_kernel(const float* __restrict__ q,
                       const __nv_bfloat16* __restrict__ planes,
                       const T* __restrict__ arena,
                       const float* __restrict__ arena_sq,
                       const float* __restrict__ scale,
                       const float* __restrict__ anchors,
                       const int* __restrict__ counts,
                       const int* __restrict__ row_list,
                       const int* __restrict__ qrow_table,
                       float* __restrict__ out_d, int* __restrict__ out_s,
                       int batch, int m, int dim, int nlist, int cap,
                       int cap_s, int k, int metric, int stages, int vec) {
  constexpr int SPL = tc::kTS / 32;  // tile slots per lane in the merge
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  float* od = out_d + static_cast<size_t>(row) * m * k;
  int* os = out_s + static_cast<size_t>(row) * m * k;
  const int list = row_list[row];
  if (list < 0 || list >= nlist) {  // sentinel row: nothing to scan
    for (int i = tid; i < m * k; i += tc::kThreads) {
      od[i] = INFINITY;
      os[i] = -1;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  const tc::Smem sm(smem, m, sizeof(T), stages);
  tc::row_setup(sm, qrow_table + static_cast<size_t>(row) * m, m, dim, 1);
  const int lim = min(counts[list], cap_s);
  const T* lbase = arena + static_cast<size_t>(list) * cap * dim;
  if (warp >= tc::kConsumerWarps) {  // the producer warps
    tc::produce<T>(sm, lbase, planes, batch, dim, lim, vec != 0);
    return;
  }

  tc::query_norms(sm, q,
                  anchors != nullptr
                      ? anchors + static_cast<size_t>(list) * dim
                      : nullptr,
                  dim);
  const int ntl = tc::live_query_tiles(sm);
  const int nlive = min(m, 8 * ntl);  // query slots worth merging
  const float* sq_l = arena_sq + static_cast<size_t>(list) * cap;
  const float* sc_l =
      scale != nullptr ? scale + static_cast<size_t>(list) * cap : nullptr;
  const int nchunks = tc::n_chunks(dim, sizeof(T));

  float bd[8][KPL];
  int bs[8][KPL];
  float kth[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    kth[i] = INFINITY;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      bd[i][j] = INFINITY;
      bs[i][j] = INT_MAX;
    }
  }

  int item = 0;
  for (int s0 = 0; s0 < lim; s0 += tc::kTS) {
    const int nt = min(tc::kTS, lim - s0);
    const int mtl = tc::live_slot_tiles(nt);
    float acc[2][8][4];
    tc::tile_mma<T>(acc, sm, item, nchunks, mtl, ntl);
    tc::consumer_sync();  // the previous tile's distances are merged
    tc::tile_distances(sm, acc, sq_l, sc_l, s0, nt, mtl, ntl, metric);
    tc::consumer_sync();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int mm = warp + tc::kConsumerWarps * i;
      if (mm < nlive) {
        const float* dr = sm.dist + mm * tc::kSStride;
        float cd[SPL];
#pragma unroll
        for (int j = 0; j < SPL; ++j) {
          const int t = lane + 32 * j;
          cd[j] = t < nt ? dr[t] : INFINITY;
        }
        warp_merge<SPL, KPL>(bd[i], bs[i], kth[i], cd, s0 + lane, k);
      }
    }
  }

  // --- write the per-query top-k -------------------------------------------
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int mm = warp + tc::kConsumerWarps * i;
    if (mm < m) {
      const bool live = sm.qi[mm] >= 0;
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

template <typename T>
cudaError_t launch_tc(const float* q, const __nv_bfloat16* planes,
                      const void* arena, const float* arena_sq,
                      const float* scale, const float* anchors,
                      const int* counts, const int* row_list,
                      const int* qrow_table, float* out_d, int* out_s,
                      int n_rows, int batch, int m, int dim, int nlist,
                      int cap, int cap_s, int k, int metric,
                      cudaStream_t stream) {
  const tc::Launch l = tc::launch_shape(m, sizeof(T), dim, arena, planes);
  if (l.stages < 2) return cudaErrorInvalidValue;
  auto kernel = k <= 32 ? grouped_scan_tc_kernel<T, 1>
                        : grouped_scan_tc_kernel<T, 2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(l.smem));
  if (err != cudaSuccess) return err;
  kernel<<<n_rows, tc::kThreads, l.smem, stream>>>(
      q, planes, static_cast<const T*>(arena), arena_sq, scale, anchors,
      counts, row_list, qrow_table, out_d, out_s, batch, m, dim, nlist, cap,
      cap_s, k, metric, l.stages, l.vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest list-row width M the scan takes at this dimension and arena dtype
// (0: none fits): 64 on int8, bf16 and fp32 arenas (D staged in chunks, so
// independent of D).
int vdb_grouped_scan_max_m(int dim, int dtype) {
  if (dim <= 0 || dtype < kInt8 || dtype > kF32) return 0;
  return tc::max_m(elem_size(dtype));
}

// Launch the grouped scan on `stream`. Returns a cudaError_t (0 = launched).
// Pointers: q [B, dim] f32; planes [3, B, dim] bf16, the query's hi / mid /
// lo split; arena [nlist, cap, dim] of
// `dtype` (0 int8, 1 bf16, 2 f32); arena_sq [nlist, cap] f32; scale
// [nlist, cap] f32 or null; anchors [nlist, dim] f32 or null; counts
// [nlist] i32; row_list [n_rows] i32; qrow_table [n_rows, m] i32; out_d /
// out_s [n_rows, m, k].
int vdb_grouped_scan(const void* q, const void* planes, const void* arena,
                     const void* arena_sq, const void* scale,
                     const void* anchors, const void* counts,
                     const void* row_list, const void* qrow_table,
                     void* out_d, void* out_s, int n_rows, int batch, int m,
                     int dim, int nlist, int cap, int cap_s, int k,
                     int metric, int dtype, void* stream) {
  if (n_rows <= 0 || batch <= 0 || m <= 0 ||
      m > vdb_grouped_scan_max_m(dim, dtype) || k <= 0 || k > 64 ||
      cap_s <= 0 || cap_s > cap || nlist <= 0 || metric < kL2 ||
      metric > kCosine || planes == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* qf = static_cast<const float*>(q);
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(planes);
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
      err = launch_tc<int8_t>(qf, qp, arena, sq, sc, an, cn, rl, qt, od, os,
                              n_rows, batch, m, dim, nlist, cap, cap_s, k,
                              metric, st);
      break;
    case kBf16:
      err = launch_tc<__nv_bfloat16>(qf, qp, arena, sq, sc, an, cn, rl, qt,
                                     od, os, n_rows, batch, m, dim, nlist,
                                     cap, cap_s, k, metric, st);
      break;
    case kF32:
      err = launch_tc<float>(qf, qp, arena, sq, sc, an, cn, rl, qt, od, os,
                             n_rows, batch, m, dim, nlist, cap, cap_s, k,
                             metric, st);
      break;
    default:
      err = cudaErrorInvalidValue;
      break;
  }
  return static_cast<int>(err);
}

}  // extern "C"
