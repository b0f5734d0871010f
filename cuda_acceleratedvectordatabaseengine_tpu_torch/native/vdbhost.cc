// Native host runtime of the vector DB engine (PyTorch / CUDA package).
//
// The host half of the reference's C++ runtime
// (engine/transfer_manager.cpp pools + staging, engine/prefetcher.cpp IO)
// that stays on the CPU: (a) assembling padded staging blocks of inverted
// lists, (b) gathering candidate rows and reranking shortlists against the
// host row store, and (c) storage readahead — all multithreaded C++ below,
// free of the Python GIL (callers use ctypes, which releases the GIL).
//
// Build: native/__init__.py runs g++ -O3 -std=c++17 -fPIC -pthread -shared
// at first use. API is extern "C" + raw pointers so ctypes binds without
// pybind11.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <thread>
#include <unistd.h>
#include <vector>

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#endif

namespace {

// Simple parallel-for over [0, n) with hardware-concurrency workers.
template <typename F>
void parallel_for(int64_t n, F&& fn, int max_threads = 0) {
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int nt = max_threads > 0 ? max_threads : (hw > 0 ? hw : 4);
  if (n < 2 || nt < 2) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  if (nt > n) nt = static_cast<int>(n);
  std::atomic<int64_t> next(0);
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&]() {
      for (;;) {
        int64_t i = next.fetch_add(1, std::memory_order_relaxed);
        if (i >= n) return;
        fn(i);
      }
    });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// 64-byte-aligned allocation (cache-line / vector friendly), the host-pool
// role of the reference's PinnedMemoryPool (transfer_manager.cpp:12-86).
void* vdb_aligned_alloc(size_t bytes) {
  void* p = nullptr;
  if (posix_memalign(&p, 64, bytes) != 0) return nullptr;
  return p;
}

void vdb_aligned_free(void* p) { free(p); }

// Assemble a padded staging block for a device upload of `n_lists` inverted
// lists: out[i, 0:counts[i], :] = lists[i], zero padding above, plus fp32
// squared norms. `list_ptrs[i]` points at counts[i]*dim contiguous floats.
// Parallel over lists; memcpy per list row-block.
void vdb_gather_lists(const float** list_ptrs, const int32_t* counts,
                      int32_t n_lists, int32_t cap, int32_t dim,
                      float* out_vectors, float* out_sq) {
  const int64_t row_bytes = static_cast<int64_t>(dim) * sizeof(float);
  parallel_for(n_lists, [&](int64_t i) {
    const float* src = list_ptrs[i];
    const int32_t c = counts[i] < cap ? counts[i] : cap;
    float* dst = out_vectors + i * static_cast<int64_t>(cap) * dim;
    float* sq = out_sq + i * static_cast<int64_t>(cap);
    std::memcpy(dst, src, static_cast<size_t>(c) * row_bytes);
    std::memset(dst + static_cast<int64_t>(c) * dim, 0,
                static_cast<size_t>(cap - c) * row_bytes);
    for (int32_t r = 0; r < c; ++r) {
      const float* row = src + static_cast<int64_t>(r) * dim;
      float acc = 0.f;
      for (int32_t d = 0; d < dim; ++d) acc += row[d] * row[d];
      sq[r] = acc;
    }
    std::memset(sq + c, 0, static_cast<size_t>(cap - c) * sizeof(float));
  });
}

// Gather rows by index: out[i, :] = src[rows[i], :]; rows[i] < 0 zero-fills.
// Backs host-side candidate fetch (rerank) and snapshot repacking.
void vdb_gather_rows(const float* src, int64_t src_rows, int32_t dim,
                     const int64_t* rows, int64_t n, float* out) {
  const int64_t row_bytes = static_cast<int64_t>(dim) * sizeof(float);
  parallel_for(n, [&](int64_t i) {
    const int64_t r = rows[i];
    float* dst = out + i * static_cast<int64_t>(dim);
    if (r < 0 || r >= src_rows) {
      std::memset(dst, 0, static_cast<size_t>(row_bytes));
    } else {
      std::memcpy(dst, src + r * static_cast<int64_t>(dim),
                  static_cast<size_t>(row_bytes));
    }
  });
}

// fp32 → bf16 (round-to-nearest-even) conversion, parallel. Staging blocks
// upload in the corpus dtype, halving H2D bytes.
void vdb_f32_to_bf16(const float* src, int64_t n, uint16_t* out) {
  parallel_for((n + (1 << 20) - 1) >> 20, [&](int64_t blk) {
    const int64_t lo = blk << 20;
    const int64_t hi = lo + (1 << 20) < n ? lo + (1 << 20) : n;
    for (int64_t i = lo; i < hi; ++i) {
      uint32_t bits;
      std::memcpy(&bits, &src[i], 4);
      const uint32_t rounding = 0x7FFF + ((bits >> 16) & 1);
      out[i] = static_cast<uint16_t>((bits + rounding) >> 16);
    }
  });
}

// Storage readahead: fadvise(WILLNEED) + optional synchronous pread warm of
// the first `touch_bytes` (the NVMeOptimizedReader role, storage.h:91-122).
int32_t vdb_readahead(const char* path, int64_t offset, int64_t length,
                      int64_t touch_bytes) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
#ifdef POSIX_FADV_WILLNEED
  posix_fadvise(fd, offset, length, POSIX_FADV_WILLNEED);
#endif
  int32_t rc = 0;
  if (touch_bytes > 0) {
    const int64_t chunk = 1 << 20;
    std::vector<char> buf(static_cast<size_t>(chunk));
    int64_t done = 0;
    while (done < touch_bytes) {
      int64_t want = touch_bytes - done < chunk ? touch_bytes - done : chunk;
      ssize_t got = pread(fd, buf.data(), static_cast<size_t>(want),
                          offset + done);
      if (got <= 0) { rc = -2; break; }
      done += got;
    }
  }
  close(fd);
  return rc;
}

int32_t vdb_hardware_concurrency() {
  return static_cast<int32_t>(std::thread::hardware_concurrency());
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused shortlist rerank (the capacity tier's host stage).
//
// The Python path (io_host/host_rerank.py) gathers B×R int8 rows, casts them
// to a [c, R, D] fp32 transient, and runs a batched GEMV — ~4× the candidate
// bytes in pure cast traffic before BLAS even starts. Here the gather,
// dequantized dot (factored as q·x̂ = qa[anchor] + scale·(q·code)) and top-k
// selection fuse into one pass per candidate row: each int8 row is read once
// and never materialized in fp32. Role-wise this is the host half of the
// reference's declared exact-rerank surface (engine/ivf_flat_index.h:153-157)
// composed with its declared host tier (format/storage.h:124-173).
// ---------------------------------------------------------------------------

namespace {

constexpr float kFltMax = 3.4028235e38f;
constexpr uint64_t kInvalidId = 0xFFFFFFFFFFFFFFFFull;

float dot_i8_scalar(const float* q, const int8_t* v, int32_t dim) {
  float acc = 0.f;
  for (int32_t d = 0; d < dim; ++d) acc += q[d] * static_cast<float>(v[d]);
  return acc;
}

float dot_f32_scalar(const float* q, const float* v, int32_t dim) {
  float acc = 0.f;
  for (int32_t d = 0; d < dim; ++d) acc += q[d] * v[d];
  return acc;
}

#if defined(__x86_64__) || defined(__i386__)

__attribute__((target("avx2,fma")))
float hsum8(__m256 v) {
  __m128 lo = _mm256_castps256_ps128(v);
  __m128 hi = _mm256_extractf128_ps(v, 1);
  lo = _mm_add_ps(lo, hi);
  lo = _mm_hadd_ps(lo, lo);
  lo = _mm_hadd_ps(lo, lo);
  return _mm_cvtss_f32(lo);
}

__attribute__((target("avx2,fma")))
float dot_i8_avx2(const float* q, const int8_t* v, int32_t dim) {
  __m256 acc0 = _mm256_setzero_ps();
  __m256 acc1 = _mm256_setzero_ps();
  int32_t d = 0;
  for (; d + 16 <= dim; d += 16) {
    __m128i bytes = _mm_loadu_si128(
        reinterpret_cast<const __m128i*>(v + d));
    __m256i w = _mm256_cvtepi8_epi16(bytes);
    __m256i i0 = _mm256_cvtepi16_epi32(_mm256_castsi256_si128(w));
    __m256i i1 = _mm256_cvtepi16_epi32(_mm256_extracti128_si256(w, 1));
    acc0 = _mm256_fmadd_ps(_mm256_loadu_ps(q + d),
                           _mm256_cvtepi32_ps(i0), acc0);
    acc1 = _mm256_fmadd_ps(_mm256_loadu_ps(q + d + 8),
                           _mm256_cvtepi32_ps(i1), acc1);
  }
  float acc = hsum8(_mm256_add_ps(acc0, acc1));
  for (; d < dim; ++d) acc += q[d] * static_cast<float>(v[d]);
  return acc;
}

__attribute__((target("avx2,fma")))
float dot_f32_avx2(const float* q, const float* v, int32_t dim) {
  __m256 acc0 = _mm256_setzero_ps();
  __m256 acc1 = _mm256_setzero_ps();
  int32_t d = 0;
  for (; d + 16 <= dim; d += 16) {
    acc0 = _mm256_fmadd_ps(_mm256_loadu_ps(q + d),
                           _mm256_loadu_ps(v + d), acc0);
    acc1 = _mm256_fmadd_ps(_mm256_loadu_ps(q + d + 8),
                           _mm256_loadu_ps(v + d + 8), acc1);
  }
  float acc = hsum8(_mm256_add_ps(acc0, acc1));
  for (; d < dim; ++d) acc += q[d] * v[d];
  return acc;
}

bool cpu_has_avx2_fma() {
  return __builtin_cpu_supports("avx2") && __builtin_cpu_supports("fma");
}
#else
bool cpu_has_avx2_fma() { return false; }
float dot_i8_avx2(const float*, const int8_t*, int32_t) { return 0.f; }
float dot_f32_avx2(const float*, const float*, int32_t) { return 0.f; }
#endif

}  // namespace

extern "C" {

// Exact rerank of per-query candidate shortlists against the flat host row
// store. vecs is [n_rows, dim] int8 (is_int8=1, factored dequant via
// scale/anchor_row/qa) or fp32 (is_int8=0). rows[i*r+j] < 0 marks an
// invalid candidate. metric: 0=L2 (needs sq, q_sq), 1=IP, 2=cosine.
// Writes out_d/out_i [b, k] ascending by distance, FLT_MAX/UINT64_MAX
// padding — the same output contract as the NumPy path it replaces.
//
// The query·anchor term comes in one of two forms:
//   qa       [b, nlist] dense — every anchor dot precomputed (a B·nlist·D
//            GEMM host-side: prohibitive on 1-vCPU hosts at nlist ≥ 4K)
//   qa_cand  [b, r] per-candidate — the caller dots only each query's
//            UNIQUE candidate anchors (≤ nprobe of them) and scatters;
//            preferred (takes precedence when both given)
void vdb_rerank(const void* vecs, int32_t is_int8, int64_t n_rows,
                int32_t dim, const float* scale, const float* sq,
                const int32_t* anchor_row, const float* qa, int32_t nlist,
                const float* queries, const float* q_sq, int32_t b,
                int32_t r, const int64_t* rows, const uint64_t* cand_ids,
                int32_t metric, int32_t k, float* out_d, uint64_t* out_i,
                const float* qa_cand) {
  const bool simd = cpu_has_avx2_fma();
  const int8_t* v8 = static_cast<const int8_t*>(vecs);
  const float* vf = static_cast<const float*>(vecs);
  parallel_for(b, [&](int64_t qi) {
    const float* q = queries + qi * static_cast<int64_t>(dim);
    const float* qa_row =
        (qa != nullptr) ? qa + qi * static_cast<int64_t>(nlist) : nullptr;
    const float* qa_c =
        (qa_cand != nullptr) ? qa_cand + qi * static_cast<int64_t>(r)
                             : nullptr;
    const float qs = (q_sq != nullptr) ? q_sq[qi] : 0.f;
    // Bounded top-k: unsorted heap-less buffer with tracked current max.
    std::vector<float> best_d(static_cast<size_t>(k), kFltMax);
    std::vector<int32_t> best_j(static_cast<size_t>(k), -1);
    int32_t filled = 0;
    int32_t max_at = 0;
    float max_d = kFltMax;
    const int64_t* row_q = rows + qi * static_cast<int64_t>(r);
    for (int32_t j = 0; j < r; ++j) {
      const int64_t row = row_q[j];
      if (row < 0 || row >= n_rows) continue;
      float dot;
      if (is_int8) {
        const int8_t* vrow = v8 + row * static_cast<int64_t>(dim);
        dot = simd ? dot_i8_avx2(q, vrow, dim) : dot_i8_scalar(q, vrow, dim);
        dot *= scale[row];
        if (qa_c != nullptr) {
          dot += qa_c[j];
        } else if (qa_row != nullptr) {
          dot += qa_row[anchor_row[row]];
        }
      } else {
        const float* vrow = vf + row * static_cast<int64_t>(dim);
        dot = simd ? dot_f32_avx2(q, vrow, dim)
                   : dot_f32_scalar(q, vrow, dim);
      }
      float d;
      if (metric == 1) {
        d = -dot;
      } else if (metric == 2) {
        d = 1.f - dot;
      } else {
        d = qs - 2.f * dot + sq[row];
        if (d < 0.f) d = 0.f;
      }
      if (filled < k) {
        best_d[filled] = d;
        best_j[filled] = j;
        ++filled;
        if (filled == k) {
          max_at = 0;
          max_d = best_d[0];
          for (int32_t t = 1; t < k; ++t)
            if (best_d[t] > max_d) { max_d = best_d[t]; max_at = t; }
        }
      } else if (d < max_d) {
        best_d[max_at] = d;
        best_j[max_at] = j;
        max_d = best_d[0];
        max_at = 0;
        for (int32_t t = 1; t < k; ++t)
          if (best_d[t] > max_d) { max_d = best_d[t]; max_at = t; }
      }
    }
    // Ascending sort, ties by candidate position (matches the stable
    // argsort in the NumPy path).
    std::vector<int32_t> order(static_cast<size_t>(filled));
    for (int32_t t = 0; t < filled; ++t) order[t] = t;
    std::sort(order.begin(), order.end(), [&](int32_t a, int32_t c) {
      if (best_d[a] != best_d[c]) return best_d[a] < best_d[c];
      return best_j[a] < best_j[c];
    });
    float* od = out_d + qi * static_cast<int64_t>(k);
    uint64_t* oi = out_i + qi * static_cast<int64_t>(k);
    const uint64_t* cid = cand_ids + qi * static_cast<int64_t>(r);
    int32_t t = 0;
    for (; t < filled; ++t) {
      od[t] = best_d[order[t]];
      oi[t] = cid[best_j[order[t]]];
    }
    for (; t < k; ++t) {
      od[t] = kFltMax;
      oi[t] = kInvalidId;
    }
  });
}

}  // extern "C"
