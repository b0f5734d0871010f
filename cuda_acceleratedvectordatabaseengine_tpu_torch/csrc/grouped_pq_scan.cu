// Grouped ADC scan over product-quantized inverted lists, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel K2,
// cuda_acceleratedvectordatabaseengine_tpu/ops/pallas_scan.py::
// scan_probed_codes_pallas_grouped (kernel body _grouped_pq_kernel). The
// torch wrapper is cuda_acceleratedvectordatabaseengine_tpu_torch/ops/
// grouped_pq_scan.py, which also holds the plain PyTorch version of the same
// function.
//
// What it computes. The (query, probed list) pairs of a batch are packed by
// the wrapper into list-rows of at most M queries that probe the same list.
// One CTA handles one list-row. Codes are stored subspace-major, codes_t
// [nlist, msub, cap] uint8; slot s of list l decodes to the residual
//     r_s = concat_j codebooks[j, codes_t[l, j, s]]        (dsub floats each)
// and for each of the row's queries and each occupied slot
// s < min(counts[l], cap_s)
//     qx = q . centroid[l] + q . r_s
//     L2: max(|q|^2 - 2 qx + code_sq[l, s], 0)   IP: -qx   cosine: 1 - qx
// (code_sq = |centroid[l] + r_s|^2). Two output modes:
//   top-k: the k smallest (distance, slot) pairs per query, ascending, ties
//          to the smaller slot, +inf / -1 past the list's end; out
//          [n_rows, M, k];
//   full:  the masked distance row of every query, +inf past the list's
//          end; out [n_rows, M, cap_s] (one top-k over the probe union
//          follows in torch).
// Sentinel rows (list id >= nlist) and empty query slots come out +inf/-1.
//
// Design. As the K1 kernel (grouped_scan.cu): the CTA reads its M query rows
// by index straight from q into shared memory, with |q|^2 and q . centroid
// once per query, then walks the list in tiles of TS = 32 slots. The tile is
// decode-staged: for each slot of the tile and each subspace j, the dsub
// floats of codebooks[j, code] are copied into a [TS, D] fp32 tile in shared
// memory (16-byte copies when dsub % 4 == 0). The codes of one subspace for
// consecutive slots are consecutive bytes of codes_t, and the codebooks
// (786 KB at m 96, dsub 8) stay in L2. The tile stays fp32, so the distance
// is the exact fp32 dot against the decoded vector, as the JAX kernel's.
// Warp w owns queries w, w+8, ...; lane t owns slot t of the tile; the
// running top-k is K1's warp_merge. Query slots that hold no query are
// skipped.
//
// What bounds it on the H100. A slot costs m bytes of codes from HBM (96 B
// at D 768, 8x fewer than K1's int8 rows), D * 4 bytes of codebook reads
// from L2 to decode it, and D FMAs per query of the row. So the decode and
// the dots bind, not HBM. Rows of one list are separate CTAs, each decoding
// the list again. When a list-row holds fewer than 8 queries, warps idle
// during the dots (the known K1 issue at small M).
//
// What later versions change: a per-query inner-product table [m, 256] in
// shared memory (m adds per slot instead of D FMAs, no decode), or wgmma on
// decoded tiles split into bf16 hi/lo parts; one decode shared by all rows
// of a list.

#include "grouped_common.cuh"

#include <cstdint>

namespace {

using namespace vdb;

constexpr int kTile = 32;  // slots per tile: one per lane

inline size_t pq_smem_bytes(int m, int dim) {
  return query_smem_bytes(m, dim) + tile_smem_bytes(dim, sizeof(float), kTile);
}

template <int MPT, int KPL, bool FULL>
__global__ void __launch_bounds__(kThreads)
grouped_pq_scan_kernel(const float* __restrict__ q,
                       const uint8_t* __restrict__ codes_t,
                       const float* __restrict__ code_sq,
                       const int* __restrict__ counts,
                       const float* __restrict__ centroids,
                       const float* __restrict__ codebooks,
                       const int* __restrict__ row_list,
                       const int* __restrict__ qrow_table,
                       float* __restrict__ out_d, int* __restrict__ out_s,
                       int m, int dim, int msub, int ks, int nlist, int cap,
                       int cap_s, int k, int metric) {
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int dsub = dim / msub;
  const int dp = padded_dim(dim);
  const int tstride = dp + 4;
  const int width = FULL ? cap_s : k;  // output entries per query slot

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [m][dp]
  float* qsq = qs + static_cast<size_t>(m) * dp;
  float* qa = qsq + m;
  int* qi = reinterpret_cast<int*>(qa + m);
  float* tile = reinterpret_cast<float*>(smem + query_smem_bytes(m, dim));

  float* od = out_d + static_cast<size_t>(row) * m * width;
  int* os = FULL ? nullptr : out_s + static_cast<size_t>(row) * m * k;
  const int list = row_list[row];
  if (list < 0 || list >= nlist) {  // sentinel row: nothing to scan
    for (int i = tid; i < m * width; i += kThreads) {
      od[i] = INFINITY;
      if (!FULL) os[i] = -1;
    }
    return;
  }

  // --- this row's queries, straight from q [B, D] --------------------------
  const int* qrow = qrow_table + static_cast<size_t>(row) * m;
  for (int i = tid; i < m; i += kThreads) qi[i] = qrow[i];
  __syncthreads();
  for (int e = tid; e < m * dp; e += kThreads) {
    const int mm = e / dp;
    const int d = e - mm * dp;
    const int b = qi[mm];
    qs[e] = (b >= 0 && d < dim) ? q[static_cast<size_t>(b) * dim + d] : 0.f;
  }
  if (dp != dim) {  // zero the pad columns of the tile once
    const int pw = dp - dim;
    for (int e = tid; e < kTile * pw; e += kThreads) {
      tile[(e / pw) * tstride + dim + e % pw] = 0.f;
    }
  }
  __syncthreads();
  const float* cen = centroids + static_cast<size_t>(list) * dim;
  for (int mm = warp; mm < m; mm += kWarps) {
    float s = 0.f;
    float a = 0.f;
    for (int d = lane; d < dim; d += 32) {
      const float v = qs[mm * dp + d];
      s = fmaf(v, v, s);
      a = fmaf(v, cen[d], a);
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
  // Query slots of this warp that hold a query (warp-uniform flags).
  bool live[MPT];
#pragma unroll
  for (int i = 0; i < MPT; ++i) {
    const int mm = warp + kWarps * i;
    live[i] = mm < m && qi[mm] >= 0;
  }
  // (the first tile's __syncthreads publishes qsq / qa)

  // --- walk the occupied slot prefix in tiles of kTile slots ---------------
  const int lim = min(counts[list], cap_s);
  const uint8_t* lcodes = codes_t + static_cast<size_t>(list) * msub * cap;
  const float* sq_l = code_sq + static_cast<size_t>(list) * cap;
  const bool vec16 = (dsub % 4 == 0) &&
                     (reinterpret_cast<uintptr_t>(codebooks) % 16 == 0);

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

  for (int s0 = 0; s0 < lim; s0 += kTile) {
    const int nt = min(kTile, lim - s0);
    __syncthreads();  // the previous tile is consumed
    // Decode-stage the tile: tile[t][j*dsub + e] = codebooks[j][code][e].
    if (vec16) {
      const int nq4 = dsub / 4;
      const int per_j = nt * nq4;
      for (int c = tid; c < msub * per_j; c += kThreads) {
        const int j = c / per_j;
        const int r = c - j * per_j;
        const int t = r / nq4;
        const int u = r - t * nq4;
        const int code = lcodes[static_cast<size_t>(j) * cap + s0 + t];
        const float4 v = __ldg(reinterpret_cast<const float4*>(
                                   codebooks + (static_cast<size_t>(j) * ks +
                                                code) * dsub) + u);
        *reinterpret_cast<float4*>(tile + t * tstride + j * dsub + 4 * u) = v;
      }
    } else {
      for (int c = tid; c < msub * nt; c += kThreads) {
        const int j = c / nt;
        const int t = c - j * nt;
        const int code = lcodes[static_cast<size_t>(j) * cap + s0 + t];
        const float* src =
            codebooks + (static_cast<size_t>(j) * ks + code) * dsub;
        float* dst = tile + t * tstride + j * dsub;
        for (int e = 0; e < dsub; ++e) dst[e] = __ldg(src + e);
      }
    }
    __syncthreads();

    float acc[MPT];
#pragma unroll
    for (int i = 0; i < MPT; ++i) acc[i] = 0.f;
    for (int d = 0; d < dp; d += 4) {
      const float4 xv = Vec4<float>::load(tile + lane * tstride + d);
#pragma unroll
      for (int i = 0; i < MPT; ++i) {
        if (live[i]) {
          const float4 qv = *reinterpret_cast<const float4*>(
              qs + (warp + kWarps * i) * dp + d);
          acc[i] = fmaf(qv.x, xv.x, acc[i]);
          acc[i] = fmaf(qv.y, xv.y, acc[i]);
          acc[i] = fmaf(qv.z, xv.z, acc[i]);
          acc[i] = fmaf(qv.w, xv.w, acc[i]);
        }
      }
    }

    const bool valid = lane < nt;
    const float xsq = valid ? sq_l[s0 + lane] : 0.f;
#pragma unroll
    for (int i = 0; i < MPT; ++i) {
      if (live[i]) {
        const int mm = warp + kWarps * i;
        const float qx = acc[i] + qa[mm];
        float dist;
        if (metric == kL2) {
          dist = fmaxf(qsq[mm] - 2.f * qx + xsq, 0.f);
        } else if (metric == kIP) {
          dist = -qx;
        } else {
          dist = 1.f - qx;
        }
        if (FULL) {
          if (valid) od[static_cast<size_t>(mm) * cap_s + s0 + lane] = dist;
        } else {
          const float cd[1] = {valid ? dist : INFINITY};
          warp_merge<1, KPL>(bd[i], bs[i], kth[i], cd, s0 + lane, k);
        }
      }
    }
  }

  // --- outputs --------------------------------------------------------------
  __syncthreads();  // qi visible even when the list is empty
  if (FULL) {
    // the slots past the list's end, and the rows of empty query slots
    for (int e = tid; e < m * cap_s; e += kThreads) {
      const int mm = e / cap_s;
      if (e - mm * cap_s >= lim || qi[mm] < 0) od[e] = INFINITY;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < MPT; ++i) {
    const int mm = warp + kWarps * i;
    if (mm < m) {
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int r = lane + 32 * j;
        if (r < k) {
          const bool hit = live[i] && bd[i][j] != INFINITY;
          od[mm * k + r] = hit ? bd[i][j] : INFINITY;
          os[mm * k + r] = hit ? bs[i][j] : -1;
        }
      }
    }
  }
}

template <int MPT, int KPL, bool FULL>
cudaError_t launch(const float* q, const uint8_t* codes_t,
                   const float* code_sq, const int* counts,
                   const float* centroids, const float* codebooks,
                   const int* row_list, const int* qrow_table, float* out_d,
                   int* out_s, int n_rows, int m, int dim, int msub, int ks,
                   int nlist, int cap, int cap_s, int k, int metric,
                   cudaStream_t stream) {
  auto kernel = grouped_pq_scan_kernel<MPT, KPL, FULL>;
  const size_t smem = pq_smem_bytes(m, dim);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<n_rows, kThreads, smem, stream>>>(
      q, codes_t, code_sq, counts, centroids, codebooks, row_list, qrow_table,
      out_d, out_s, m, dim, msub, ks, nlist, cap, cap_s, k, metric);
  return cudaGetLastError();
}

template <int KPL, bool FULL>
cudaError_t dispatch_m(int mpt, const float* q, const uint8_t* codes_t,
                       const float* code_sq, const int* counts,
                       const float* centroids, const float* codebooks,
                       const int* row_list, const int* qrow_table,
                       float* out_d, int* out_s, int n_rows, int m, int dim,
                       int msub, int ks, int nlist, int cap, int cap_s, int k,
                       int metric, cudaStream_t stream) {
#define VDB_LAUNCH(MPT)                                                     \
  return launch<MPT, KPL, FULL>(q, codes_t, code_sq, counts, centroids,     \
                                codebooks, row_list, qrow_table, out_d,     \
                                out_s, n_rows, m, dim, msub, ks, nlist, cap, \
                                cap_s, k, metric, stream)
  if (mpt <= 1) VDB_LAUNCH(1);
  if (mpt <= 2) VDB_LAUNCH(2);
  if (mpt <= 4) VDB_LAUNCH(4);
  VDB_LAUNCH(8);
#undef VDB_LAUNCH
}

}  // namespace

extern "C" {

// Largest list-row width M whose queries and decoded slot tile fit the
// shared memory of one CTA at this dimension (0: none fits).
int vdb_grouped_pq_scan_max_m(int dim) {
  if (dim <= 0) return 0;
  int m = 0;
  while (m < 64 && pq_smem_bytes(m + 1, dim) <= kSmemLimit) ++m;
  return m;
}

// Launch the grouped ADC scan on `stream`. Returns a cudaError_t (0 =
// launched). Pointers: q [B, dim] f32; codes_t [nlist, msub, cap] u8;
// code_sq [nlist, cap] f32; counts [nlist] i32; centroids [nlist, dim] f32;
// codebooks [msub, ks, dim / msub] f32; row_list [n_rows] i32; qrow_table
// [n_rows, m] i32; out_d [n_rows, m, full ? cap_s : k] f32; out_s
// [n_rows, m, k] i32 (top-k mode only; null when full != 0).
int vdb_grouped_pq_scan(const void* q, const void* codes_t,
                        const void* code_sq, const void* counts,
                        const void* centroids, const void* codebooks,
                        const void* row_list, const void* qrow_table,
                        void* out_d, void* out_s, int n_rows, int m, int dim,
                        int msub, int ks, int nlist, int cap, int cap_s, int k,
                        int full, int metric, void* stream) {
  if (n_rows <= 0 || m <= 0 || m > vdb_grouped_pq_scan_max_m(dim) ||
      msub <= 0 || dim % msub != 0 || ks <= 0 || ks > 256 || cap_s <= 0 ||
      cap_s > cap || nlist <= 0 || metric < kL2 || metric > kCosine ||
      (!full && (k <= 0 || k > 64 || out_s == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int mpt = (m + kWarps - 1) / kWarps;
  const float* qf = static_cast<const float*>(q);
  const uint8_t* ct = static_cast<const uint8_t*>(codes_t);
  const float* sq = static_cast<const float*>(code_sq);
  const int* cn = static_cast<const int*>(counts);
  const float* ce = static_cast<const float*>(centroids);
  const float* cb = static_cast<const float*>(codebooks);
  const int* rl = static_cast<const int*>(row_list);
  const int* qt = static_cast<const int*>(qrow_table);
  float* od = static_cast<float*>(out_d);
  int* os = static_cast<int*>(out_s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (full) {
    err = dispatch_m<1, true>(mpt, qf, ct, sq, cn, ce, cb, rl, qt, od, os,
                              n_rows, m, dim, msub, ks, nlist, cap, cap_s, k,
                              metric, st);
  } else if (k <= 32) {
    err = dispatch_m<1, false>(mpt, qf, ct, sq, cn, ce, cb, rl, qt, od, os,
                               n_rows, m, dim, msub, ks, nlist, cap, cap_s, k,
                               metric, st);
  } else {
    err = dispatch_m<2, false>(mpt, qf, ct, sq, cn, ce, cb, rl, qt, od, os,
                               n_rows, m, dim, msub, ks, nlist, cap, cap_s, k,
                               metric, st);
  }
  return static_cast<int>(err);
}

}  // extern "C"
