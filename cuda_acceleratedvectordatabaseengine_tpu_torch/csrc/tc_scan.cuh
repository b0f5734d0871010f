// The tensor-core dot engine of the flat list-row scans K1 (grouped_scan.cu)
// and K3 (full_row_scan.cu, vdb_sorted_scan), and of K4 (vdb_pair_scan),
// on int8, bf16 and fp32 arenas, for Hopper (sm_90a).
//
// Replaces the fp32 CUDA-core dot loop that K1 and K3 shared, which took
// the place of the TPU kernels' MXU dots in
// cuda_acceleratedvectordatabaseengine_tpu/ops/pallas_scan.py
// (_grouped_kernel, _sorted_kernel).
//
// Exact bf16 products. The wrapper splits each fp32 query into three bf16
// planes (hi = bf16(q), mid = bf16(q - hi), lo = bf16(q - hi - mid);
// hi + mid + lo == q exactly). Every int8 code and every bf16 arena value
// is exact in bf16, so q . x is the sum of three bf16 x bf16 tensor-core
// products. An fp32 arena value is not: the consumers split it the same
// way in registers as they build the A fragments (split_f32x2), and q . x
// is the sum of the six products hh, hm, mh, hl, lh, mm of query and
// arena planes (relative size 1, 2^-8, 2^-16). The three left out (ml, lm,
// ll, 2^-24 and below) add up to at most about 3 * 2^-24 * sum |q_i x_i|,
// fp32's own product rounding; hh, hm and mh alone leave 2^-16 of it,
// outside the scans' tolerance where the lo planes line up with the
// query's signs (tests/test_torch_f32_planes.py). Each product is exact;
// the query and the arena are not rounded.
//
// Sums. They are fp32, but not an fp32 loop's: an mma's add into its
// accumulator truncates instead of rounding to nearest, so the error of
// one accumulator grows with the number of mma calls and with |q . x| (with
// one accumulator over D 768, 144 calls, the scan differed from its plain
// fp32 version by 97% of the scans' tolerance on a raw bf16 arena with
// |q|^2 ~ 823). Each chunk of D therefore gets a fresh accumulator for
// at most 12 mma calls, the small products first (64-wide chunks: four
// k-steps of three products; fp32's 32-wide chunks: two k-steps of six),
// and the chunks' partial dots are added on the CUDA cores, rounded to
// nearest: as close to float64 as the plain fp32 version or closer
// (PERF.md).
//
// Design. One CTA of 10 warps takes one list-row (up to M <= 64 queries that
// probe the same list). The list is walked in tiles of TS = 256 slots, and
// each tile's D axis in chunks of DK elements (64 on int8 / bf16, 32 on
// fp32). A ring of 2-4 stages in shared memory holds, per (tile, chunk),
// the slot rows' chunk (arena[list, s0:s0+256, d0:d0+DK]) and the row's
// query planes' chunk ([3][M][DK] bf16, re-read from L2 for every tile).
// Warps 8-9 are the producers: their lanes fill a stage with cp.async
// (zero-filled past the list's count, past D and for empty query slots) and
// signal the stage's "full" mbarrier through cp.async.mbarrier.arrive; the
// consumers release it through its "empty" mbarrier. Warps 0-7 are the
// consumers: warp w owns slots 32w .. 32w+31 of the tile (two m16 tiles)
// and every query of the row (up to eight n8 tiles), and runs
// mma.sync.m16n8k16 bf16 with fp32 accumulators; an int8 tile element is
// widened to bf16 once, in registers (exact, by the fp32 magic-number
// trick), an fp32 one split into its three planes. The fp32 accumulator
// tile goes through shared memory as distances (scale, anchor, |x|^2,
// metric and the valid-slot mask applied as before) to the kernel's
// epilogue: K1's warp_merge top-k, K3's coalesced full-row writes. Only
// live query tiles and live slot tiles are multiplied.
//
// Shared memory, M 64: 1.3 KB of head, the 66.5 KB distance tile, and per
// stage the slot rows (256 x 64 B int8, 256 x 144 B bf16 and fp32) and
// the plane chunk (3 x 64 x 144 B, fp32 3 x 64 x 64 B): 44.0, 64.5 and
// 49.2 KB, so 3, 2 and 3 stages in 227 KB. A 64-wide fp32 chunk (97.3 KB a
// stage) would leave room for one.
//
// Inside a chunk, lane t % 4 of a warp owns the DK / 4 elements
// (DK / 4) (t % 4) .. (DK / 4) (t % 4 + 1) - 1 of its rows, so 16-byte
// shared loads give it its k-steps' elements (four k-steps of an int8 row
// in one load). A k-step's logical k index maps to the physical element
// the same way for the slot (A) and the query (B) fragments, so the
// permutation cancels in the dot.
//
// What bounds it (H100 SXM, 700 W, the IVF-Flat main shape: D 768,
// nlist 1024, cap 1408, B 1024, nprobe 32): HBM bytes. int8 residual: 0.245
// ms for K1 and 0.30 ms for K3 (the probed lists once, plus K3's 185 MB of
// rows), against 3 x 52.5 GFLOP, 0.16 ms at 989 TFLOP/s. fp32: 0.96 ms for
// K1 and 1.02 ms for K3 (3.2 and 3.4 GB), against 6 x 54 GFLOP, 0.33 ms.
//
// Where K1's time goes on int8 (builds with parts of the kernel edited
// out, timed at that shape on an NVIDIA H100 80GB HBM3 at 700 W, 1.95 ms
// as is): 0.82 ms with both the mma and the top-k merge removed (the ring,
// the distances, the query norms), 1.32 ms without the mma, 1.31 ms without
// the merge. The three parts add up because the consumer warps run them
// one after another; the fp32 loop this engine replaced took 17 ms on int8,
// 2.1 ms of it outside the dots, and 32 ms on fp32 (PERF.md).
//
// On fp32 arenas (same shape and card) K1 takes 3.07 ms and K3 2.41 ms,
// 3.2x and 2.4x their bytes bound. K1 takes 1.92, 2.21 and 3.07 ms for
// 0.82, 1.62 and 3.26 GB of int8, bf16 and fp32 rows: its time follows the
// mma calls (three or six products a k-step) far more than the bytes.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "grouped_common.cuh"

namespace vdb {
namespace tc {

constexpr int kConsumerWarps = 8;
constexpr int kProducerWarps = 2;
constexpr int kProducerThreads = 32 * kProducerWarps;
constexpr int kThreads = 32 * (kConsumerWarps + kProducerWarps);
constexpr int kTS = 256;           // slots per tile: 32 per consumer warp
constexpr int kMaxM = 64;          // queries per list-row: 8 n8 tiles
constexpr int kMaxStages = 4;
constexpr int kSStride = kTS + 4;  // floats per distance row (bank spread)

// D elements per chunk of an `elem`-byte arena: 64 for int8 / bf16, 32 for
// fp32 (two k-steps of six products: 12 mma calls a fresh accumulator).
__host__ __device__ constexpr int chunk_dk(int elem) {
  return elem == 4 ? 32 : 64;
}

__host__ __device__ constexpr int n_chunks(int dim, int elem) {
  return (dim + chunk_dk(elem) - 1) / chunk_dk(elem);
}

// Bytes per slot row in a stage: int8 64, bf16 and fp32 128 + 16 of pad.
// Either way the 8 rows a quarter-warp's 16-byte loads read fall in
// distinct banks.
__host__ __device__ constexpr int slot_stride(int elem) {
  return elem == 1 ? 64 : 144;
}

// bf16 elements per query-plane row in a stage: 72 (144 B) for 64-wide
// chunks, 32 (64 B, no pad needed) for fp32's 32-wide ones.
__host__ __device__ constexpr int plane_stride(int elem) {
  return elem == 4 ? 32 : 72;
}

__host__ __device__ inline int padded_m(int m) { return (m + 7) & ~7; }

// Shared memory of one list-row CTA: barriers, per-query row offset / index
// / |q|^2 / q.anchor, the distance tile [mpad][kSStride] fp32, the ring.
struct Layout {
  int mpad;
  int stages;
  size_t head;         // barriers + qi + qsq + qa
  size_t dist_bytes;
  size_t stage_bytes;  // slot chunk + plane chunk

  __host__ __device__ Layout(int m, int elem, int n_stages) {
    mpad = padded_m(m);
    head = align16(2 * kMaxStages * sizeof(uint64_t) +
                   static_cast<size_t>(mpad) * (8 + 3 * 4));
    dist_bytes = static_cast<size_t>(mpad) * kSStride * 4;
    stage_bytes = static_cast<size_t>(kTS) * slot_stride(elem) +
                  3 * static_cast<size_t>(mpad) * plane_stride(elem) * 2;
    stages = n_stages;
  }
  __host__ __device__ size_t fixed_bytes() const { return head + dist_bytes; }
  __host__ __device__ size_t bytes() const {
    return fixed_bytes() + stages * stage_bytes;
  }
};

// Ring depth that fits the 227 KB of one CTA (at most kMaxStages; below 2
// the row does not fit).
__host__ inline int fit_stages(int m, int elem) {
  const Layout l(m, elem, 0);
  const size_t room = kSmemLimit - l.fixed_bytes();
  const int s = static_cast<int>(room / l.stage_bytes);
  return s < kMaxStages ? s : kMaxStages;
}

// Widest list-row the tensor-core scans take on an arena of `elem` bytes
// per value (independent of D: the D axis is staged in chunks).
__host__ inline int max_m(int elem) {
  int m = 0;
  while (m < kMaxM && fit_stages(m + 1, elem) >= 2) ++m;
  return m;
}

// How a list-row kernel of width m on `elem`-byte arena values launches:
// ring depth, dynamic shared memory, and whether the ring is filled with
// 16-byte copies (rows and planes 16-byte aligned) or element by element.
struct Launch {
  int stages;
  size_t smem;
  int vec;
};

__host__ inline Launch launch_shape(int m, int elem, int dim,
                                    const void* arena, const void* planes) {
  Launch l;
  l.stages = fit_stages(m, elem);
  l.smem = Layout(m, elem, l.stages).bytes();
  // a 16-byte piece never straddles two rows of the arena or the planes
  l.vec = dim * elem % 16 == 0 && dim % 8 == 0 &&
          reinterpret_cast<uintptr_t>(arena) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(planes) % 16 == 0;
  return l;
}

// --- PTX helpers ------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(smem_addr(bar))
      : "memory");
}

// Arrive on `bar` once every cp.async this thread issued has landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              unsigned parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of `bar` with this parity has completed. A wait of
// seconds can only be a broken ring: trap instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > 10000000000LL) __trap();
  }
}

// 16 bytes global -> shared; src_bytes 0 writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The consumer warps' barrier (named barrier 1; the producer is not in it).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kConsumerWarps) : "memory");
}

// c += a . b on the tensor cores: m16n8k16, bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four int8 (one word, lowest byte first) to two bf16x2 words, exactly:
// byte u = x + 128 goes into the mantissa of 2^23 (0x4B0000uu), and
// subtracting 2^23 + 128 leaves x, an integer that bf16 holds exactly, so
// the fp32's upper half is its bf16.
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) -
                   8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) -
                   8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) -
                   8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) -
                   8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// Two fp32 values as bf16x2 bits, rounded to nearest (the first value in
// the low half, where an mma fragment takes the lower k index).
__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two fp32 arena values split into their hi / mid / lo bf16 planes, as
// split_query_bf16x3 splits a query (ops/grouped_scan.py), each plane's
// pair in one word: both differences are exact in fp32, and hi + mid + lo
// == x unless the lo plane falls below bf16's smallest subnormal 2^-133
// (|x| < 2^-110), where the sum is off by at most 2^-134.
__device__ __forceinline__ void split_f32x2(float x0, float x1, uint32_t& h,
                                            uint32_t& m, uint32_t& l) {
  h = bf16x2_bits(x0, x1);
  const float r0 = x0 - __uint_as_float(h << 16);
  const float r1 = x1 - __uint_as_float(h & 0xffff0000u);
  m = bf16x2_bits(r0, r1);
  l = bf16x2_bits(r0 - __uint_as_float(m << 16),
                  r1 - __uint_as_float(m & 0xffff0000u));
}

// Zero of an arena element type (the ring's element-wise fill).
template <typename T>
__device__ __forceinline__ T zero_elem() {
  return T(0);
}

template <>
__device__ __forceinline__ __nv_bfloat16 zero_elem<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

// --- shared memory views ------------------------------------------------------

struct Smem {
  uint64_t* full;   // [kMaxStages]
  uint64_t* empty;  // [kMaxStages]
  long long* qoff;  // [mpad] element offset of the query's row, -1 = empty
  int* qi;          // [mpad] pair / query index, -1 = empty
  float* qsq;       // [mpad] |q|^2
  float* qa;        // [mpad] q . anchor
  float* dist;      // [mpad][kSStride]
  unsigned char* ring;
  Layout lay;
  int elem;

  __device__ Smem(unsigned char* base, int m, int elem_size, int stages)
      : lay(m, elem_size, stages), elem(elem_size) {
    full = reinterpret_cast<uint64_t*>(base);
    empty = full + kMaxStages;
    qoff = reinterpret_cast<long long*>(empty + kMaxStages);
    qi = reinterpret_cast<int*>(qoff + lay.mpad);
    qsq = reinterpret_cast<float*>(qi + lay.mpad);
    qa = qsq + lay.mpad;
    dist = reinterpret_cast<float*>(base + lay.head);
    ring = base + lay.fixed_bytes();
  }
  __device__ unsigned char* slots(int stage) const {
    return ring + stage * lay.stage_bytes;
  }
  __device__ __nv_bfloat16* planes(int stage) const {
    return reinterpret_cast<__nv_bfloat16*>(
        slots(stage) + static_cast<size_t>(kTS) * slot_stride(elem));
  }
};

// Every thread: barriers set up (thread 0), the row's query slots loaded
// (qi[mm] = qrow[mm], -1 past m; query qi / qdiv, whose rows start at
// element qoff = (qi / qdiv) * dim of q and of each plane). Ends with
// __syncthreads().
__device__ __forceinline__ void row_setup(const Smem& sm, const int* qrow,
                                          int m, int dim, int qdiv) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      mbar_init(&sm.full[s], kProducerThreads);   // every producer lane
      mbar_init(&sm.empty[s], kConsumerWarps);    // one arrive per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < sm.lay.mpad; i += kThreads) {
    const int qv = i < m ? qrow[i] : -1;
    sm.qi[i] = qv;
    sm.qoff[i] = qv >= 0 ? static_cast<long long>(qv / qdiv) * dim : -1;
  }
  __syncthreads();
}

// --- the producer warps ---------------------------------------------------------

// Fill the ring for every (tile, chunk) of slots [0, lim) of one list, in
// the order the consumers take them; run by the kProducerWarps warps after
// the consumers. `vec`: rows and planes are 16-byte aligned (cp.async, each
// lane a fixed 16-byte column of the chunk, so its loops only step
// pointers); otherwise plain copies, element by element.
template <typename T>
__device__ void produce(const Smem& sm, const T* __restrict__ lbase,
                        const __nv_bfloat16* __restrict__ planes, int batch,
                        int dim, int lim, bool vec) {
  constexpr int kDK = chunk_dk(sizeof(T));
  constexpr int kPS = plane_stride(sizeof(T));
  const int pl = threadIdx.x - 32 * kConsumerWarps;  // 0 .. kProducerThreads
  const int nchunks = n_chunks(dim, sizeof(T));
  const int mpad = sm.lay.mpad;
  const int sstride = slot_stride(sizeof(T));
  const size_t plane_elems = static_cast<size_t>(batch) * dim;
  int item = 0;
  for (int s0 = 0; s0 < lim; s0 += kTS) {
    const int nt = min(kTS, lim - s0);
    for (int c = 0; c < nchunks; ++c, ++item) {
      const int stage = item % sm.lay.stages;
      if (item >= sm.lay.stages) {
        mbar_wait(&sm.empty[stage], ((item / sm.lay.stages) - 1) & 1);
      }
      const int d0 = c * kDK;
      unsigned char* xs = sm.slots(stage);
      __nv_bfloat16* qp = sm.planes(stage);
      if (vec) {
        constexpr int kEps = 16 / sizeof(T);   // elements per 16 bytes
        constexpr int kSegs = kDK / kEps;      // 16-byte pieces per row chunk
        constexpr int kRowStep = kProducerThreads / kSegs;
        const int seg = pl % kSegs;
        const int d = d0 + seg * kEps;
        const bool dok = d < dim;
        int t = pl / kSegs;
        const T* src = lbase + static_cast<size_t>(s0 + t) * dim + d;
        unsigned char* dst = xs + t * sstride + seg * 16;
        for (; t < kTS; t += kRowStep) {
          const bool ok = dok && t < nt;
          cp_async16(dst, ok ? src : lbase, ok);
          src += static_cast<size_t>(kRowStep) * dim;
          dst += kRowStep * sstride;
        }
        constexpr int kPSegs = kDK / 8;        // 8 bf16 a piece
        const int pseg = pl % kPSegs;
        const bool pok = d0 + 8 * pseg < dim;
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          const __nv_bfloat16* pbase = planes + p * plane_elems + d0 + 8 * pseg;
          for (int mm = pl / kPSegs; mm < mpad;
               mm += kProducerThreads / kPSegs) {
            const long long off = sm.qoff[mm];
            const bool ok = pok && off >= 0;
            cp_async16(qp + (p * mpad + mm) * kPS + 8 * pseg,
                       ok ? pbase + off : planes, ok);
          }
        }
        cp_async_arrive(&sm.full[stage]);
      } else {
        for (int i = pl; i < kTS * kDK; i += kProducerThreads) {
          const int t = i / kDK;
          const int d = d0 + i % kDK;
          T v = zero_elem<T>();
          if (t < nt && d < dim) v = lbase[static_cast<size_t>(s0 + t) * dim + d];
          reinterpret_cast<T*>(xs + t * sstride)[i % kDK] = v;
        }
        for (int i = pl; i < 3 * mpad * kDK; i += kProducerThreads) {
          const int r = i / kDK;
          const int p = r / mpad;
          const long long off = sm.qoff[r - p * mpad];
          const int d = d0 + i % kDK;
          __nv_bfloat16 v = __ushort_as_bfloat16(0);
          if (off >= 0 && d < dim) v = planes[p * plane_elems + off + d];
          qp[r * kPS + i % kDK] = v;
        }
        mbar_arrive(&sm.full[stage]);
      }
    }
  }
  cp_async_wait_all();
}

// --- the consumer warps -----------------------------------------------------------

// |q|^2 and q . anchor of the row's queries in fp32 (warp w takes queries
// w, w+8, ...; 0 for empty slots), from q [B, D]; ends with consumer_sync().
__device__ __forceinline__ void query_norms(const Smem& sm,
                                            const float* __restrict__ q,
                                            const float* __restrict__ anc,
                                            int dim) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int mm = warp; mm < sm.lay.mpad; mm += kConsumerWarps) {
    const long long off = sm.qoff[mm];
    float s = 0.f;
    float a = 0.f;
    if (off >= 0) {
      const float* qr = q + off;
      for (int d = lane; d < dim; d += 32) {
        const float v = qr[d];
        s = fmaf(v, v, s);
        if (anc != nullptr) a = fmaf(v, anc[d], a);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(kFull, s, off);
      a += __shfl_xor_sync(kFull, a, off);
    }
    if (lane == 0) {
      sm.qsq[mm] = s;
      sm.qa[mm] = a;
    }
  }
  consumer_sync();
}

// Live n8 query tiles of the row: up to the last non-empty query slot.
__device__ __forceinline__ int live_query_tiles(const Smem& sm) {
  int last = -1;
  for (int mm = 0; mm < sm.lay.mpad; ++mm) {
    if (sm.qi[mm] >= 0) last = mm;
  }
  return (last + 8) >> 3;
}

// One product of fp32-arena planes into part (both k-steps of a 32-wide
// chunk, the warp's live m16 tiles): query plane QP of b, arena plane XP
// of a (0 hi, 1 mid, 2 lo).
template <int QP, int XP>
__device__ __forceinline__ void plane_product(float (&part)[2][4],
                                              const uint32_t (&a)[3][2][2][4],
                                              const uint32_t (&b)[3][4],
                                              int mtl) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      if (mt < mtl) mma_bf16(part[mt], a[XP][mt][j], b[QP][2 * j],
                             b[QP][2 * j + 1]);
}

// tile_mma on an fp32 arena. Lane t % 4 owns elements 8 (t % 4) .. 8 (t % 4)
// + 7 of a 32-wide chunk: two 16-byte loads of each of its slot rows (k-step
// j takes the j-th), one of each query-plane row. Each slot value is split
// into its three planes as the A fragments are built, and each chunk's six
// products go into a fresh accumulator, 12 mma calls, the smallest first:
// (query, arena) planes mm, lh, hl (2^-16 of the dot), mh, hm (2^-8), hh.
// With NORMS and `norms` (K4, L2) each of the lane's four slot rows also
// gets its |x|^2 from the fp32 values it loads (not from their hi plane):
// eight FMAs a chunk into a fresh fp32 partial, the partials added in fp64
// over the chunks and over the quad's four lanes, rounded to fp32 once
// (a lane-serial fp32 chain over D 768 lies seven to nine times as far
// from float64: tests/test_torch_f32_planes.py).
template <bool NORMS>
__device__ __forceinline__ void tile_mma_f32(float (&acc)[2][8][4],
                                             const Smem& sm, int& item,
                                             int nchunks, int mtl, int ntl,
                                             float (*xsq)[2], bool norms) {
  constexpr int kSlot = slot_stride(4);
  constexpr int kPS = plane_stride(4);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c4 = lane & 3;
  const int mpad = sm.lay.mpad;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  norms = NORMS && norms;
  double xd[2][2] = {};  // |x|^2 of this lane's elements of its four rows

  for (int c = 0; c < nchunks; ++c, ++item) {
    const int stage = item % sm.lay.stages;
    mbar_wait(&sm.full[stage], (item / sm.lay.stages) & 1);
    const unsigned char* xs = sm.slots(stage);
    const __nv_bfloat16* qp = sm.planes(stage);

    // A fragments of the two k-steps in three planes: a[plane][mt][j]
    uint32_t a[3][2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (mt < mtl) {
        const int r0 = 32 * warp + 16 * mt + g;
        const float4* p0 =
            reinterpret_cast<const float4*>(xs + r0 * kSlot + 32 * c4);
        const float4* p1 =
            reinterpret_cast<const float4*>(xs + (r0 + 8) * kSlot + 32 * c4);
        float n0 = 0.f, n1 = 0.f;  // this chunk's partial |x|^2, rows g, g + 8
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float4 x0 = p0[j];
          const float4 x1 = p1[j];
          split_f32x2(x0.x, x0.y, a[0][mt][j][0], a[1][mt][j][0],
                      a[2][mt][j][0]);
          split_f32x2(x1.x, x1.y, a[0][mt][j][1], a[1][mt][j][1],
                      a[2][mt][j][1]);
          split_f32x2(x0.z, x0.w, a[0][mt][j][2], a[1][mt][j][2],
                      a[2][mt][j][2]);
          split_f32x2(x1.z, x1.w, a[0][mt][j][3], a[1][mt][j][3],
                      a[2][mt][j][3]);
          if (NORMS && norms) {
            n0 = fmaf(x0.x, x0.x, n0);
            n0 = fmaf(x0.y, x0.y, n0);
            n0 = fmaf(x0.z, x0.z, n0);
            n0 = fmaf(x0.w, x0.w, n0);
            n1 = fmaf(x1.x, x1.x, n1);
            n1 = fmaf(x1.y, x1.y, n1);
            n1 = fmaf(x1.z, x1.z, n1);
            n1 = fmaf(x1.w, x1.w, n1);
          }
        }
        if (NORMS && norms) {
          xd[mt][0] += static_cast<double>(n0);
          xd[mt][1] += static_cast<double>(n1);
        }
      }
    }
    if (mtl > 0) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (n < ntl) {
          uint32_t b[3][4];
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            const uint4 v = *reinterpret_cast<const uint4*>(
                qp + (p * mpad + 8 * n + g) * kPS + 8 * c4);
            b[p][0] = v.x;
            b[p][1] = v.y;
            b[p][2] = v.z;
            b[p][3] = v.w;
          }
          float part[2][4] = {};
          plane_product<1, 1>(part, a, b, mtl);
          plane_product<2, 0>(part, a, b, mtl);
          plane_product<0, 2>(part, a, b, mtl);
          plane_product<1, 0>(part, a, b, mtl);
          plane_product<0, 1>(part, a, b, mtl);
          plane_product<0, 0>(part, a, b, mtl);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][n][e] += part[mt][e];
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[stage]);
  }
  if constexpr (NORMS) {  // the four lanes of a quad share their rows
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        double v = xd[mt][h];
        v += __shfl_xor_sync(kFull, v, 1);
        v += __shfl_xor_sync(kFull, v, 2);
        xsq[mt][h] = static_cast<float>(v);  // 0 when not `norms`
      }
  }
}

// One tile's dots: acc[mt][n] is the m16 x n8 block of slots
// 32 w + 16 mt + (0..15) and queries 8 n + (0..7), summed over every chunk
// of D (each chunk's three plane products on the tensor cores, six on an
// fp32 arena (tile_mma_f32), the chunks' partial dots in fp32 on the CUDA
// cores). `item` counts ring stages consumed; `nchunks` is n_chunks(D,
// sizeof(T)). `mtl` live m16 tiles of this warp, `ntl` live n8 tiles of
// the row. With NORMS (K4, every arena dtype) the lane's four slot rows
// (32 w + 16 mt + g + 8 h, the rows tile_distances gives this lane) get
// xsq[mt][h]: when `norms` (L2), |x|^2 formed on the CUDA cores from the
// values each chunk loads anyway (int8 exactly in int32 with dp4a, bf16 as
// fp32 FMAs of exact products, fp32 as fp32 partials a chunk added in
// fp64), summed over the chunks and then over the four lanes that share a
// row; else 0.
template <typename T, bool NORMS = false>
__device__ __forceinline__ void tile_mma(float (&acc)[2][8][4], const Smem& sm,
                                         int& item, int nchunks, int mtl,
                                         int ntl, float (*xsq)[2] = nullptr,
                                         bool norms = false) {
  if constexpr (sizeof(T) == 4) {
    tile_mma_f32<NORMS>(acc, sm, item, nchunks, mtl, ntl, xsq, norms);
  } else {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2;   // fragment row group
    const int c4 = lane & 3;   // owns elements 16 c4 .. 16 c4 + 15 of a chunk
    const int mpad = sm.lay.mpad;
    const int sstride = slot_stride(sizeof(T));
    constexpr int kPS = plane_stride(sizeof(T));
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
    norms = NORMS && norms;
    float xf[2][2] = {};  // bf16 rows: partial |x|^2 of this lane's elements
    int xi[2][2] = {};    // int8 rows

    for (int c = 0; c < nchunks; ++c, ++item) {
      const int stage = item % sm.lay.stages;
      mbar_wait(&sm.full[stage], (item / sm.lay.stages) & 1);
      const unsigned char* xs = sm.slots(stage);
      const __nv_bfloat16* qp = sm.planes(stage);

      // A fragments of the four k-steps: a[mt][j] for rows g and g + 8
      uint32_t a[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt < mtl) {
          const int r0 = 32 * warp + 16 * mt + g;
          if constexpr (sizeof(T) == 1) {
            const uint4 x0 = *reinterpret_cast<const uint4*>(
                xs + r0 * sstride + 16 * c4);
            const uint4 x1 = *reinterpret_cast<const uint4*>(
                xs + (r0 + 8) * sstride + 16 * c4);
            const uint32_t w0[4] = {x0.x, x0.y, x0.z, x0.w};
            const uint32_t w1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              i8x4_to_bf16(w0[j], a[mt][j][0], a[mt][j][2]);
              i8x4_to_bf16(w1[j], a[mt][j][1], a[mt][j][3]);
            }
            if (norms) {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                xi[mt][0] = __dp4a(static_cast<int>(w0[j]),
                                   static_cast<int>(w0[j]), xi[mt][0]);
                xi[mt][1] = __dp4a(static_cast<int>(w1[j]),
                                   static_cast<int>(w1[j]), xi[mt][1]);
              }
            }
          } else {
            const uint4* p0 = reinterpret_cast<const uint4*>(
                xs + r0 * sstride + 32 * c4);
            const uint4* p1 = reinterpret_cast<const uint4*>(
                xs + (r0 + 8) * sstride + 32 * c4);
            const uint4 x0a = p0[0], x0b = p0[1], x1a = p1[0], x1b = p1[1];
            const uint32_t w0[8] = {x0a.x, x0a.y, x0a.z, x0a.w,
                                    x0b.x, x0b.y, x0b.z, x0b.w};
            const uint32_t w1[8] = {x1a.x, x1a.y, x1a.z, x1a.w,
                                    x1b.x, x1b.y, x1b.z, x1b.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              a[mt][j][0] = w0[2 * j];
              a[mt][j][2] = w0[2 * j + 1];
              a[mt][j][1] = w1[2 * j];
              a[mt][j][3] = w1[2 * j + 1];
            }
            if (norms) {
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const float l0 = __uint_as_float(w0[j] << 16);
                const float h0 = __uint_as_float(w0[j] & 0xffff0000u);
                const float l1 = __uint_as_float(w1[j] << 16);
                const float h1 = __uint_as_float(w1[j] & 0xffff0000u);
                xf[mt][0] = fmaf(l0, l0, xf[mt][0]);
                xf[mt][0] = fmaf(h0, h0, xf[mt][0]);
                xf[mt][1] = fmaf(l1, l1, xf[mt][1]);
                xf[mt][1] = fmaf(h1, h1, xf[mt][1]);
              }
            }
          }
        }
      }
      if (mtl > 0) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          if (n < ntl) {
            // The chunk's dot in a fresh accumulator, lo and mid planes
            // first, then added to acc on the CUDA cores (round to nearest):
            // the tensor cores' accumulating adds truncate, so one
            // accumulator over all of D would lose about an ulp of the whole
            // dot per mma.
            float part[2][4] = {};
#pragma unroll
            for (int p = 2; p >= 0; --p) {
              const uint4* bp = reinterpret_cast<const uint4*>(
                  qp + (p * mpad + 8 * n + g) * kPS + 16 * c4);
              const uint4 ba = bp[0], bb = bp[1];
              const uint32_t b[8] = {ba.x, ba.y, ba.z, ba.w,
                                     bb.x, bb.y, bb.z, bb.w};
#pragma unroll
              for (int j = 0; j < 4; ++j) {
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
                  if (mt < mtl) mma_bf16(part[mt], a[mt][j], b[2 * j],
                                         b[2 * j + 1]);
                }
              }
            }
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[mt][n][e] += part[mt][e];
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.empty[stage]);
    }
    if constexpr (NORMS) {  // the four lanes of a quad share their rows
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v;
          if constexpr (sizeof(T) == 1) {
            int iv = xi[mt][h];
            iv += __shfl_xor_sync(kFull, iv, 1);
            iv += __shfl_xor_sync(kFull, iv, 2);
            v = static_cast<float>(iv);
          } else {
            v = xf[mt][h];
            v += __shfl_xor_sync(kFull, v, 1);
            v += __shfl_xor_sync(kFull, v, 2);
          }
          xsq[mt][h] = v;  // 0 when not `norms`: nothing was summed
        }
    }
  }
}

// The tile's distances into sm.dist[mm][t] (t < nt; scale, anchor, |x|^2
// and the metric applied as flat_distance does), for this warp's live m16
// tiles and the row's live n8 tiles. The caller brackets it with
// consumer_sync().
__device__ __forceinline__ void tile_distances(
    const Smem& sm, const float (&acc)[2][8][4], const float* __restrict__ sq_l,
    const float* __restrict__ sc_l, int s0, int nt, int mtl, int ntl,
    int metric, const float (*xs)[2] = nullptr) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    if (mt < mtl) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = 32 * warp + 16 * mt + g + 8 * h;
        const bool valid = t < nt;
        // |x|^2: the lane's own sums (tile_mma, K4), else the stored norm
        const float xsq = xs != nullptr ? xs[mt][h]
                          : (valid && sq_l != nullptr) ? sq_l[s0 + t]
                                                       : 0.f;
        const float sc = (valid && sc_l != nullptr) ? sc_l[s0 + t] : 1.f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          if (n < ntl) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int mm = 8 * n + 2 * c4 + e;
              sm.dist[mm * kSStride + t] =
                  valid ? flat_distance(metric,
                                        acc[mt][n][2 * h + e] * sc + sm.qa[mm],
                                        sm.qsq[mm], xsq)
                        : INFINITY;
            }
          }
        }
      }
    }
  }
}

// Live m16 tiles of this warp in a tile of nt slots.
__device__ __forceinline__ int live_slot_tiles(int nt) {
  const int base = 32 * (threadIdx.x >> 5);
  return nt > base + 16 ? 2 : (nt > base ? 1 : 0);
}

}  // namespace tc
}  // namespace vdb
