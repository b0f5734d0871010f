// Full-row probed-list scans for Hopper (sm_90a): the sorted scan (K3) and
// the pair scan (K4). Both write one distance row per (query, probe) pair,
// +inf where a slot is empty or the probe is -1; the torch wrappers take the
// top-k outside, as the TPU versions left it to XLA.
//
// K3, vdb_sorted_scan, replaces
// cuda_acceleratedvectordatabaseengine_tpu/ops/pallas_scan.py::
// scan_probed_lists_pallas_sorted (kernel body _sorted_kernel). Wrapper and
// plain PyTorch version: cuda_acceleratedvectordatabaseengine_tpu_torch/ops/
// sorted_scan.py.
//
// What it computes. For pair (b, p) probing list l and each slot
// s < cap_s: qx = scale[l,s] * (q_b . code[l,s]) + q_b . anchor[l] (scale 1
// and anchor 0 when absent), and the distance
//     L2: max(|q_b|^2 - 2 qx + arena_sq[l,s], 0)   IP: -qx   cosine: 1 - qx,
// +inf for s >= min(count_l, cap_s) (count_l is the local count under slot
// striping) and for probe -1. Row of pair (b, p) goes to out[b * P + p].
//
// Design. The TPU kernel sorted the pairs by list so consecutive grid steps
// could reuse one VMEM block. Here the wrapper sorts the pairs by list on
// the device and packs runs of same-list pairs into list-rows of at most M
// pairs (the packing of K1). One CTA takes one list-row.
// sorted_scan_tc_kernel runs the dots on the tensor cores, on exact bf16
// products, on the engine K1 shares (tc_scan.cuh): the wrapper splits the
// fp32 queries into three bf16 planes once per call; two producer warps
// stream 256-slot tiles, D in chunks (64 wide on int8 / bf16 arenas, 32 on
// fp32, whose values the consumers split into three bf16 planes in
// registers), and the row's plane chunks through a cp.async ring ordered
// by mbarriers; eight consumer warps run mma.sync m16n8k16 bf16 with fp32
// accumulators (a fresh one per chunk, the chunks summed on the CUDA
// cores), write each tile's distances to shared memory, then write each
// pair's row segment to its (b, p) place with coalesced stores. Pairs of
// probe -1 sit in sentinel rows (list id nlist), which read nothing and
// write +inf rows.
//
// What bounds K3 on the H100 (SXM, 700 W). At the IVF-Flat main shape
// (B 1024, nprobe 32, about 1000 rows a list, D 768) it must read the
// probed lists once and write 185 MB of rows: about 1 GB on int8, 0.30 ms
// at 3.35 TB/s, against three bf16 products of 53 GFLOP, 0.16 ms at
// 989 TFLOP/s; 3.4 GB on fp32, 1.02 ms, against six products, 0.33 ms. So
// bytes bound it. This kernel takes 1.33 ms on int8 (4.4x the bound) and
// 2.41 ms on fp32 (2.4x); the fp32 CUDA-core loop of the first version
// took 17.0 and 12.6 ms (NVIDIA H100 80GB HBM3, 700 W), and timed builds of
// K1 with parts edited out put that time in the shared dot loop.
//
// K4, vdb_pair_scan, replaces pallas_scan.py::scan_probed_lists_pallas
// (kernel body _kernel). Wrapper and plain version: ops/pair_scan.py.
//
// What it computes. The same rows from the stored block alone: norms are
// recomputed from the stored values (arena_sq is not read), there is no scale
// and no anchor (an int8 arena is scanned as raw code values),
//     L2: max(|q|^2 - 2 q.x + |x|^2, 0)   IP: -q.x   cosine: 1 - q.x.
//
// Design. The TPU grid had one step per (query, probe) pair, each reading its
// list's block again. A pair-per-CTA kernel on this card is bound by that
// re-reading: at the bf16 main shape (32 768 pairs over 1024 lists of about
// 1000 rows, D 768) it pulled 53 GB through L2 in 8.1 ms, took twice as long
// when handed the pairs out of list order, and no less without its |x|^2
// FMAs; on fp32 arenas it took 10.1 ms, 9.8x its bound (NVIDIA H100 80GB
// HBM3, 700 W). So K4 runs K3's list-rows on K3's kernel, on every arena
// dtype: sorted_scan_tc_kernel<T, BLOCK = true> reads a list once per row of
// up to 64 same-list pairs, multiplies on the tensor cores (exact bf16
// operands as K3's: three query planes, and on fp32 arenas three planes of
// each value, six products), and takes the one thing K3 has not, |x|^2 of
// each slot, from the values tile_mma loads anyway: int8 exactly in int32
// (dp4a), bf16 as fp32 FMAs of exact products, fp32 from the fp32 values
// themselves (not their hi plane) as a fresh fp32 partial of eight FMAs a
// chunk, the partials added in fp64; once per tile and not once per pair,
// summed over the D chunks as the ring delivers them and over the four lanes
// that share a slot row. IP and cosine form no norms. What bounds it then is
// what bounds K3: the bytes (each probed list once, the rows out; 1.8 GB,
// 0.54 ms at the bf16 main shape; 3.4 GB, 1.03 ms on fp32). The launch takes
// 1.56 ms on bf16 and 2.44 ms on fp32 there (2.9x and 2.4x; NVIDIA H100 80GB
// HBM3, 700 W); its fp32 distances lie at most 0.07 of the scans' tolerance
// from float64.

#include "grouped_common.cuh"
#include "tc_scan.cuh"

#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>

namespace {

using namespace vdb;

// Tensor-core list-row scan on int8, bf16 and fp32 arenas: full rows out.
// BLOCK is the norm source: false, K3 (arena_sq, with scale and anchor);
// true, K4 (|x|^2 formed from the staged chunks by tile_mma, nothing else
// read).
template <typename T, bool BLOCK>
__global__ void __launch_bounds__(tc::kThreads, 1)
sorted_scan_tc_kernel(const float* __restrict__ q,
                      const __nv_bfloat16* __restrict__ planes,
                      const T* __restrict__ arena,
                      const float* __restrict__ arena_sq,
                      const float* __restrict__ scale,
                      const float* __restrict__ anchors,
                      const int* __restrict__ counts,
                      const int* __restrict__ row_list,
                      const int* __restrict__ pair_table,
                      float* __restrict__ out, int batch, int m, int dim,
                      int nlist, int cap, int cap_s, int nprobe, int metric,
                      int stages, int vec) {
  const int row = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = tc::kThreads / 32;

  const int* prow = pair_table + static_cast<size_t>(row) * m;
  const int list = row_list[row];
  if (list < 0 || list >= nlist) {  // sentinel row: pairs of probe -1
    for (int mm = warp; mm < m; mm += nwarps) {
      const int p = prow[mm];
      if (p < 0) continue;
      float* o = out + static_cast<size_t>(p) * cap_s;
      for (int s = lane; s < cap_s; s += 32) o[s] = INFINITY;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  const tc::Smem sm(smem, m, sizeof(T), stages);
  tc::row_setup(sm, prow, m, dim, nprobe);
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
  const int nlive = min(m, 8 * ntl);
  const float* sq_l =
      BLOCK ? nullptr : arena_sq + static_cast<size_t>(list) * cap;
  const float* sc_l =
      scale != nullptr ? scale + static_cast<size_t>(list) * cap : nullptr;
  const int nchunks = tc::n_chunks(dim, sizeof(T));
  const bool block_norms = BLOCK && metric == kL2;

  int item = 0;
  for (int s0 = 0; s0 < lim; s0 += tc::kTS) {
    const int nt = min(tc::kTS, lim - s0);
    const int mtl = tc::live_slot_tiles(nt);
    float acc[2][8][4];
    float xs[2][2];
    tc::tile_mma<T, BLOCK>(acc, sm, item, nchunks, mtl, ntl, xs, block_norms);
    tc::consumer_sync();  // the previous tile's rows are written
    tc::tile_distances(sm, acc, sq_l, sc_l, s0, nt, mtl, ntl, metric,
                       BLOCK ? xs : nullptr);
    tc::consumer_sync();
    for (int mm = warp; mm < nlive; mm += tc::kConsumerWarps) {
      const int p = sm.qi[mm];
      if (p < 0) continue;
      const float* dr = sm.dist + mm * tc::kSStride;
      float* o = out + static_cast<size_t>(p) * cap_s + s0;
      for (int t = lane; t < nt; t += 32) o[t] = dr[t];
    }
  }

  // --- slots past the list's count: +inf -----------------------------------
  for (int mm = warp; mm < m; mm += tc::kConsumerWarps) {
    const int p = sm.qi[mm];
    if (p < 0) continue;
    float* o = out + static_cast<size_t>(p) * cap_s;
    for (int s = lim + lane; s < cap_s; s += 32) o[s] = INFINITY;
  }
}

template <typename T, bool BLOCK>
cudaError_t launch_sorted_tc(const float* q, const __nv_bfloat16* planes,
                             const void* arena, const float* arena_sq,
                             const float* scale, const float* anchors,
                             const int* counts, const int* row_list,
                             const int* pair_table, float* out, int n_rows,
                             int batch, int m, int dim, int nlist, int cap,
                             int cap_s, int nprobe, int metric,
                             cudaStream_t stream) {
  const tc::Launch l = tc::launch_shape(m, sizeof(T), dim, arena, planes);
  if (l.stages < 2) return cudaErrorInvalidValue;
  auto kernel = sorted_scan_tc_kernel<T, BLOCK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(l.smem));
  if (err != cudaSuccess) return err;
  kernel<<<n_rows, tc::kThreads, l.smem, stream>>>(
      q, planes, static_cast<const T*>(arena), arena_sq, scale, anchors,
      counts, row_list, pair_table, out, batch, m, dim, nlist, cap, cap_s,
      nprobe, metric, l.stages, l.vec);
  return cudaGetLastError();
}

// One launch of the tensor-core list-row kernel with either norm source,
// K3 (BLOCK false) or K4 (BLOCK true), on an int8, bf16 or fp32 arena.
template <bool BLOCK>
cudaError_t launch_list_rows_tc(const void* q, const void* planes,
                                const void* arena, const void* arena_sq,
                                const void* scale, const void* anchors,
                                const void* counts, const void* row_list,
                                const void* pair_table, void* out, int n_rows,
                                int batch, int m, int dim, int nlist, int cap,
                                int cap_s, int nprobe, int metric, int dtype,
                                void* stream) {
  const float* qf = static_cast<const float*>(q);
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(planes);
  const float* sq = static_cast<const float*>(arena_sq);
  const float* sc = static_cast<const float*>(scale);
  const float* an = static_cast<const float*>(anchors);
  const int* cn = static_cast<const int*>(counts);
  const int* rl = static_cast<const int*>(row_list);
  const int* pt = static_cast<const int*>(pair_table);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kInt8) {
    return launch_sorted_tc<int8_t, BLOCK>(
        qf, qp, arena, sq, sc, an, cn, rl, pt, o, n_rows, batch, m, dim, nlist,
        cap, cap_s, nprobe, metric, st);
  }
  if (dtype == kBf16) {
    return launch_sorted_tc<__nv_bfloat16, BLOCK>(
        qf, qp, arena, sq, sc, an, cn, rl, pt, o, n_rows, batch, m, dim, nlist,
        cap, cap_s, nprobe, metric, st);
  }
  if (dtype == kF32) {
    return launch_sorted_tc<float, BLOCK>(
        qf, qp, arena, sq, sc, an, cn, rl, pt, o, n_rows, batch, m, dim, nlist,
        cap, cap_s, nprobe, metric, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Largest list-row width M of the list-row scans (K3, K4) at
// this dimension and arena dtype (0: none fits): 64 on int8, bf16 and fp32
// arenas (D staged in chunks, so independent of D).
int vdb_sorted_scan_max_m(int dim, int dtype) {
  if (dim <= 0 || dtype < kInt8 || dtype > kF32) return 0;
  return tc::max_m(elem_size(dtype));
}

// Launch the sorted scan (K3) on `stream`. Returns a cudaError_t (0 =
// launched). Pointers: q [B, dim] f32; planes [3, B, dim] bf16, the query's
// hi / mid / lo split; arena
// [nlist, cap, dim] of `dtype` (0 int8, 1 bf16, 2 f32); arena_sq
// [nlist, cap] f32; scale [nlist, cap] f32 or null; anchors [nlist, dim]
// f32 or null; counts [nlist] i32 (local); row_list [n_rows] i32 (nlist =
// sentinel row); pair_table [n_rows, m] i32 (pair index b * nprobe + p,
// -1 = empty); out [B * nprobe, cap_s] f32, every row of a listed pair
// written.
int vdb_sorted_scan(const void* q, const void* planes, const void* arena,
                    const void* arena_sq, const void* scale,
                    const void* anchors, const void* counts,
                    const void* row_list, const void* pair_table, void* out,
                    int n_rows, int batch, int m, int dim, int nlist, int cap,
                    int cap_s, int nprobe, int metric, int dtype,
                    void* stream) {
  if (n_rows <= 0 || batch <= 0 || m <= 0 ||
      m > vdb_sorted_scan_max_m(dim, dtype) || cap_s <= 0 || cap_s > cap ||
      nlist <= 0 || nprobe <= 0 || metric < kL2 || metric > kCosine ||
      arena_sq == nullptr || planes == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_list_rows_tc<false>(
      q, planes, arena, arena_sq, scale, anchors, counts, row_list, pair_table,
      out, n_rows, batch, m, dim, nlist, cap, cap_s, nprobe, metric, dtype,
      stream));
}

// Launch the pair scan (K4) on `stream`: K3's tensor-core list-row kernel
// with the norms taken from the stored block. Returns a cudaError_t (0 =
// launched). Pointers as for vdb_sorted_scan, without arena_sq, scale and
// anchors; dtype 0 (int8), 1 (bf16) or 2 (f32).
int vdb_pair_scan(const void* q, const void* planes, const void* arena,
                  const void* counts, const void* row_list,
                  const void* pair_table, void* out, int n_rows, int batch,
                  int m, int dim, int nlist, int cap, int cap_s, int nprobe,
                  int metric, int dtype, void* stream) {
  if (n_rows <= 0 || batch <= 0 || m <= 0 ||
      m > vdb_sorted_scan_max_m(dim, dtype) || cap_s <= 0 || cap_s > cap ||
      nlist <= 0 || nprobe <= 0 || metric < kL2 || metric > kCosine ||
      planes == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_list_rows_tc<true>(
      q, planes, arena, nullptr, nullptr, nullptr, counts, row_list,
      pair_table, out, n_rows, batch, m, dim, nlist, cap, cap_s, nprobe,
      metric, dtype, stream));
}

}  // extern "C"
