// Grouped ADC scan over product-quantized inverted lists, for Hopper
// (sm_90a): a per-query inner-product table kernel and a query-major scan
// kernel that looks the table up from shared memory.
//
// Replaces the TPU kernel K2,
// cuda_acceleratedvectordatabaseengine_tpu/ops/pallas_scan.py::
// scan_probed_codes_pallas_grouped (kernel body _grouped_pq_kernel). The
// torch wrapper is cuda_acceleratedvectordatabaseengine_tpu_torch/ops/
// grouped_pq_scan.py, which also holds the plain PyTorch version of the same
// function.
//
// What it computes. Codes are stored subspace-major, codes_t
// [nlist, msub, cap] uint8; slot s of list l decodes to the residual
//     r_s = concat_j codebooks[j, codes_t[l, j, s]]        (dsub floats each)
// and for each (query b, probe p) pair with list l = probe[b, p] and each
// occupied slot s < min(counts[l], cap_s)
//     qx = q_b . centroid[l] + q_b . r_s
//     L2: max(|q_b|^2 - 2 qx + code_sq[l, s], 0)   IP: -qx   cosine: 1 - qx
// (code_sq = |centroid[l] + r_s|^2). Two output modes, both per pair, in
// (b, p) order:
//   top-k: the k smallest (distance, slot) pairs, ascending, ties to the
//          smaller slot, +inf / -1 past the list's end; out [B * P, k];
//   full:  the masked distance row, +inf past the list's end; out
//          [B * P, cap_s] (one top-k over the probe union follows in torch).
// Pairs of probe -1 (or a list id >= nlist) come out +inf / -1.
//
// Design. The TPU kernel decoded each list with one-hot MXU products
// because Mosaic has no gather, and dotted the decoded block with the
// queries. The residual codebooks are shared by all lists, so
//     q_b . r_s = sum_j T[b, j, codes_t[l, j, s]],
//     T[b, j, c] = sum_e q[b, j dsub + e] codebooks[j, c, e],
// and the list enters only through q_b . centroid[l] and code_sq[l, s].
// pq_table_kernel makes T [B, msub, 256] in fp32 (one CTA per subspace and
// group of 16 queries, one thread per codeword, the sum over e in order).
// pq_table_scan_kernel is query-major: a CTA takes one query and a group of
// its probes, copies the query's table (msub KB; 96 KB at m 96, two CTAs an
// SM) into shared memory with 16-byte cp.async, and each of its 8 warps
// takes probed lists one at a time. A lane owns 4 consecutive slots: per
// subspace one 32-bit load of codes_t[l, j, s .. s+3] (128 coalesced bytes a
// warp: the subspace-major layout is made for this; 8 subspaces' loads are in
// flight at once), four shared-memory lookups, four adds, j ascending; then
// qx = sum + q . centroid. The running top-k is warp_merge (grouped_common.
// cuh) over the lane's 4 candidates. No pair packing, no decode, no D-long
// dot; full rows land in (b, p) order.
//
// Where the table does not fit the shared memory of a CTA (msub KB + the
// query > 227 KB, msub > 220 or so), the same kernel reads the table in
// place, from global memory through L2 (template SMEM_TABLE = false); the
// wrapper chooses by shape.
//
// What bounds it on the H100. The function needs the table product (0.2
// GFLOP) and m adds per (pair, occupied slot) (0.4 G at the IVF-PQ main
// shape: D 768, m 96, nlist 4096, cap 384, B 512, nprobe 32), 0.009 ms at
// the fp32 CUDA-core peak, and its inputs once (codes and norms of the
// probed lists, centroids, codebooks, queries; 0.08 GB with the rows out),
// 0.023 ms at the HBM rate: the bound is the bytes'. (Counted as a decode
// and a D-long dot per pair-slot, as the replaced kernel did it, the same
// function is 6.2 GFLOP, 0.09 ms.) The kernel's 0.4 G lookups hit 32 random
// banks a warp, and each pair reads its list's codes again. The
// kernel it replaces decoded 32-slot tiles into fp32 shared memory and ran D
// FMAs a (query, slot): timed builds with parts edited out (NVIDIA H100 80GB
// HBM3, 700 W, 3.40 ms as it was) put 1.1 ms in the decode, 1.1 ms in the
// dots and 0.95 ms in the rest (query rows, norms, top-k). This one takes
// 0.45 ms (table kernel 0.04 ms in it), and the same kind of edited builds
// find no single limiter: without the shared-memory lookups 0.35 ms, without
// the code loads (each pair reads its list again, 0.4 GB from L2 / HBM)
// 0.33, without the top-k merge 0.37, without the table copy 0.44, with none
// of the four 0.14 (table kernel, q . centroid, norms, stores, launch).

#include "grouped_common.cuh"
#include "tc_scan.cuh"

#include <cstdint>

namespace {

using namespace vdb;

constexpr int kKs = 256;           // codewords per subspace: 8-bit codes
constexpr int kTableQueries = 16;  // queries per CTA of the table kernel
constexpr int kSlotsPerLane = 4;   // one 32-bit code load per subspace
constexpr int kStep = 32 * kSlotsPerLane;  // slots per warp step
constexpr int kUnroll = 8;         // subspaces whose code loads are in flight

// T[b, j, c] = sum_e q[b, j dsub + e] codebooks[j, c, e], e ascending.
// Grid (query groups, msub); thread c owns codeword c of subspace j.
__global__ void __launch_bounds__(kKs)
pq_table_kernel(const float* __restrict__ q,
                const float* __restrict__ codebooks,
                float* __restrict__ table, int batch, int dim, int msub,
                int dsub) {
  const int b0 = blockIdx.x * kTableQueries;
  const int j = blockIdx.y;
  const int c = threadIdx.x;
  const int nq = min(kTableQueries, batch - b0);

  extern __shared__ __align__(16) float qsub[];  // [kTableQueries][dsub]
  for (int i = c; i < kTableQueries * dsub; i += kKs) {
    const int qb = i / dsub;
    const int e = i - qb * dsub;
    qsub[i] = qb < nq ? q[static_cast<size_t>(b0 + qb) * dim + j * dsub + e]
                      : 0.f;
  }
  __syncthreads();

  float acc[kTableQueries];
#pragma unroll
  for (int qb = 0; qb < kTableQueries; ++qb) acc[qb] = 0.f;
  const float* cw = codebooks + (static_cast<size_t>(j) * kKs + c) * dsub;
  for (int e = 0; e < dsub; ++e) {
    const float v = __ldg(cw + e);
#pragma unroll
    for (int qb = 0; qb < kTableQueries; ++qb) {
      acc[qb] = fmaf(qsub[qb * dsub + e], v, acc[qb]);
    }
  }
#pragma unroll
  for (int qb = 0; qb < kTableQueries; ++qb) {
    if (qb < nq) {
      table[(static_cast<size_t>(b0 + qb) * msub + j) * kKs + c] = acc[qb];
    }
  }
}

// Shared memory of a scan CTA: the query's table (when staged) and the query.
inline size_t scan_smem_bytes(int msub, int dim, bool smem_table) {
  return (smem_table ? static_cast<size_t>(msub) * kKs * sizeof(float) : 0) +
         sizeof(float) * padded_dim(dim);
}

template <int KPL, bool FULL, bool SMEM_TABLE>
__global__ void __launch_bounds__(kThreads, 2)
pq_table_scan_kernel(const float* __restrict__ q,
                     const float* __restrict__ table,
                     const uint8_t* __restrict__ codes_t,
                     const float* __restrict__ code_sq,
                     const int* __restrict__ counts,
                     const float* __restrict__ centroids,
                     const int* __restrict__ probe,
                     float* __restrict__ out_d, int* __restrict__ out_s,
                     int nprobe, int ppc, int dim, int msub, int nlist,
                     int cap, int cap_s, int k, int metric) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int groups = (nprobe + ppc - 1) / ppc;
  const int b = blockIdx.x / groups;
  const int p0 = (blockIdx.x - b * groups) * ppc;
  const int p1 = min(p0 + ppc, nprobe);

  extern __shared__ __align__(16) unsigned char smem[];
  float* tab = reinterpret_cast<float*>(smem);  // [msub][256] when staged
  float* qs = tab + (SMEM_TABLE ? static_cast<size_t>(msub) * kKs : 0);
  const float* tb = table + static_cast<size_t>(b) * msub * kKs;
  if (SMEM_TABLE) {  // rows of 1 KB: 16-byte pieces, always aligned
    for (int i = tid; i < msub * (kKs / 4); i += kThreads) {
      tc::cp_async16(tab + 4 * i, tb + 4 * i, true);
    }
  }
  for (int d = tid; d < dim; d += kThreads) {
    qs[d] = q[static_cast<size_t>(b) * dim + d];
  }
  if (SMEM_TABLE) tc::cp_async_wait_all();
  __syncthreads();

  float qsq = 0.f;  // every warp forms |q|^2 itself (dim / 32 FMAs a lane)
  if (metric == kL2) {
    for (int d = lane; d < dim; d += 32) qsq = fmaf(qs[d], qs[d], qsq);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      qsq += __shfl_xor_sync(kFull, qsq, off);
    }
  }
  const bool vec4 = (cap % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(codes_t) % 4 == 0);
  const int width = FULL ? cap_s : k;

  for (int p = p0 + warp; p < p1; p += kWarps) {
    const size_t pair = static_cast<size_t>(b) * nprobe + p;
    const int list = probe[pair];
    const bool real = list >= 0 && list < nlist;
    const int lim = real ? min(counts[list], cap_s) : 0;
    float* od = out_d + pair * width;

    float qa = 0.f;  // q . centroid[list]
    if (lim > 0) {
      const float* cen = centroids + static_cast<size_t>(list) * dim;
      for (int d = lane; d < dim; d += 32) qa = fmaf(qs[d], __ldg(cen + d), qa);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        qa += __shfl_xor_sync(kFull, qa, off);
      }
    }
    const uint8_t* lcodes =
        codes_t + static_cast<size_t>(real ? list : 0) * msub * cap;
    const float* sq_l = code_sq + static_cast<size_t>(real ? list : 0) * cap;

    float bd[KPL];
    int bs[KPL];
    float kth = INFINITY;
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      bd[j] = INFINITY;
      bs[j] = INT_MAX;
    }

    // full rows are written over all of cap_s, +inf past the list's end
    const int send = FULL ? cap_s : lim;
    for (int s0 = 0; s0 < send; s0 += kStep) {
      const int s = s0 + kSlotsPerLane * lane;
      const int nv = min(max(lim - s, 0), kSlotsPerLane);  // valid slots here
      float acc[kSlotsPerLane] = {0.f, 0.f, 0.f, 0.f};
      if (s0 < lim) {  // warp-uniform
        const uint8_t* lc = lcodes + s;
        if (vec4) {
          for (int j0 = 0; j0 < msub; j0 += kUnroll) {
            uint32_t w[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              w[u] = (j0 + u < msub && nv > 0)
                         ? __ldg(reinterpret_cast<const uint32_t*>(
                               lc + static_cast<size_t>(j0 + u) * cap))
                         : 0u;
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              if (j0 + u < msub) {
                if (SMEM_TABLE) {
                  const float* tj = tab + (j0 + u) * kKs;
                  acc[0] += tj[w[u] & 0xffu];
                  acc[1] += tj[(w[u] >> 8) & 0xffu];
                  acc[2] += tj[(w[u] >> 16) & 0xffu];
                  acc[3] += tj[w[u] >> 24];
                } else {
                  const float* tj = tb + (j0 + u) * kKs;
                  acc[0] += __ldg(tj + (w[u] & 0xffu));
                  acc[1] += __ldg(tj + ((w[u] >> 8) & 0xffu));
                  acc[2] += __ldg(tj + ((w[u] >> 16) & 0xffu));
                  acc[3] += __ldg(tj + (w[u] >> 24));
                }
              }
            }
          }
        } else {  // cap not a multiple of 4: byte loads
          for (int j = 0; j < msub; ++j) {
            const uint8_t* lj = lc + static_cast<size_t>(j) * cap;
#pragma unroll
            for (int i = 0; i < kSlotsPerLane; ++i) {
              const int code = i < nv ? lj[i] : 0;
              acc[i] += SMEM_TABLE ? tab[j * kKs + code]
                                   : __ldg(tb + j * kKs + code);
            }
          }
        }
      }
      float cd[kSlotsPerLane];
#pragma unroll
      for (int i = 0; i < kSlotsPerLane; ++i) {
        cd[i] = INFINITY;
        if (i < nv) {
          cd[i] = flat_distance(metric, acc[i] + qa, qsq, sq_l[s + i]);
        }
      }
      if (FULL) {
        if (cap_s % 4 == 0) {  // rows start 16-byte aligned
          if (s < cap_s) {
            *reinterpret_cast<float4*>(od + s) =
                make_float4(cd[0], cd[1], cd[2], cd[3]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < kSlotsPerLane; ++i) {
            if (s + i < cap_s) od[s + i] = cd[i];
          }
        }
      } else {
        warp_merge<kSlotsPerLane, KPL, 1>(bd, bs, kth, cd, s, k);
      }
    }

    if (!FULL) {
      int* os = out_s + pair * k;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int r = lane + 32 * j;
        if (r < k) {
          const bool hit = bd[j] != INFINITY;
          od[r] = hit ? bd[j] : INFINITY;
          os[r] = hit ? bs[j] : -1;
        }
      }
    }
  }
}

template <int KPL, bool FULL, bool SMEM_TABLE>
cudaError_t launch(const float* q, const float* table, const uint8_t* codes_t,
                   const float* code_sq, const int* counts,
                   const float* centroids, const int* probe, float* out_d,
                   int* out_s, int batch, int nprobe, int ppc, int dim,
                   int msub, int nlist, int cap, int cap_s, int k, int metric,
                   cudaStream_t stream) {
  auto kernel = pq_table_scan_kernel<KPL, FULL, SMEM_TABLE>;
  const size_t smem = scan_smem_bytes(msub, dim, SMEM_TABLE);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int groups = (nprobe + ppc - 1) / ppc;
  kernel<<<batch * groups, kThreads, smem, stream>>>(
      q, table, codes_t, code_sq, counts, centroids, probe, out_d, out_s,
      nprobe, ppc, dim, msub, nlist, cap, cap_s, k, metric);
  return cudaGetLastError();
}

template <int KPL, bool FULL>
cudaError_t dispatch_table(bool smem_table, const float* q, const float* table,
                           const uint8_t* codes_t, const float* code_sq,
                           const int* counts, const float* centroids,
                           const int* probe, float* out_d, int* out_s,
                           int batch, int nprobe, int ppc, int dim, int msub,
                           int nlist, int cap, int cap_s, int k, int metric,
                           cudaStream_t stream) {
  if (smem_table) {
    return launch<KPL, FULL, true>(q, table, codes_t, code_sq, counts,
                                   centroids, probe, out_d, out_s, batch,
                                   nprobe, ppc, dim, msub, nlist, cap, cap_s,
                                   k, metric, stream);
  }
  return launch<KPL, FULL, false>(q, table, codes_t, code_sq, counts,
                                  centroids, probe, out_d, out_s, batch,
                                  nprobe, ppc, dim, msub, nlist, cap, cap_s, k,
                                  metric, stream);
}

}  // namespace

extern "C" {

// Launch the table kernel on `stream`: table [batch, msub, 256] f32 from
// q [batch, dim] f32 and codebooks [msub, 256, dim / msub] f32. Returns a
// cudaError_t (0 = launched).
int vdb_pq_tables(const void* q, const void* codebooks, void* table,
                  int batch, int dim, int msub, void* stream) {
  if (batch <= 0 || msub <= 0 || msub > 65535 || dim <= 0 ||
      dim % msub != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int dsub = dim / msub;
  const size_t smem = sizeof(float) * kTableQueries * dsub;
  if (smem > static_cast<size_t>(kSmemLimit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      pq_table_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((batch + kTableQueries - 1) / kTableQueries, msub);
  pq_table_kernel<<<grid, kKs, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(codebooks),
      static_cast<float*>(table), batch, dim, msub, dsub);
  return static_cast<int>(cudaGetLastError());
}

// Launch the grouped ADC scan on `stream`. Returns a cudaError_t (0 =
// launched). Pointers: q [batch, dim] f32; table [batch, msub, 256] f32
// (vdb_pq_tables); codes_t [nlist, msub, cap] u8; code_sq [nlist, cap] f32;
// counts [nlist] i32; centroids [nlist, dim] f32; probe [batch, nprobe] i32
// (-1 = no probe); out_d [batch * nprobe, full ? cap_s : k] f32; out_s
// [batch * nprobe, k] i32 (top-k mode only; null when full != 0). ppc: probes
// per CTA (a CTA takes one query and ppc of its probes). smem_table != 0
// stages the query's table in shared memory (it must fit); 0 reads it in
// place.
int vdb_grouped_pq_scan(const void* q, const void* table, const void* codes_t,
                        const void* code_sq, const void* counts,
                        const void* centroids, const void* probe, void* out_d,
                        void* out_s, int batch, int nprobe, int ppc, int dim,
                        int msub, int nlist, int cap, int cap_s, int k,
                        int full, int metric, int smem_table, void* stream) {
  if (batch <= 0 || nprobe <= 0 || ppc <= 0 || msub <= 0 || dim <= 0 ||
      dim % msub != 0 || cap_s <= 0 || cap_s > cap || nlist <= 0 ||
      metric < kL2 || metric > kCosine ||
      scan_smem_bytes(msub, dim, smem_table != 0) >
          static_cast<size_t>(kSmemLimit) ||
      (!full && (k <= 0 || k > 64 || out_s == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* qf = static_cast<const float*>(q);
  const float* tb = static_cast<const float*>(table);
  const uint8_t* ct = static_cast<const uint8_t*>(codes_t);
  const float* sq = static_cast<const float*>(code_sq);
  const int* cn = static_cast<const int*>(counts);
  const float* ce = static_cast<const float*>(centroids);
  const int* pr = static_cast<const int*>(probe);
  float* od = static_cast<float*>(out_d);
  int* os = static_cast<int*>(out_s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool st_tab = smem_table != 0;
  cudaError_t err;
  if (full) {
    err = dispatch_table<1, true>(st_tab, qf, tb, ct, sq, cn, ce, pr, od, os,
                                  batch, nprobe, ppc, dim, msub, nlist, cap,
                                  cap_s, k, metric, st);
  } else if (k <= 32) {
    err = dispatch_table<1, false>(st_tab, qf, tb, ct, sq, cn, ce, pr, od, os,
                                   batch, nprobe, ppc, dim, msub, nlist, cap,
                                   cap_s, k, metric, st);
  } else {
    err = dispatch_table<2, false>(st_tab, qf, tb, ct, sq, cn, ce, pr, od, os,
                                   batch, nprobe, ppc, dim, msub, nlist, cap,
                                   cap_s, k, metric, st);
  }
  return static_cast<int>(err);
}

}  // extern "C"
