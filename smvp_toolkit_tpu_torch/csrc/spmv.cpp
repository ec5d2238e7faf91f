// Native CPU SpMV backend (shared library, ctypes ABI).
//
// A copy of the JAX package's native/spmv.cpp with the same C signatures:
// the reference's CSR traversal (main-cli.c:410-416) and the TJDS
// jagged-diagonal loop, compiled -O3 -march=native on the host (the
// Makefile's flags, ops/_build.py SPMV_CXX_FLAGS), single-threaded or
// row-block threaded. The host backend that the CLI runs on an explicit
// `--kernel native` (ops/spmv_native.py); it is never a fallback.

#include <cstdint>
#include <thread>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

void csr_rows(const long long* row_ptr, const int32_t* col, const float* val,
              const float* x, float* y, long long r0, long long r1,
              int iterations) {
  // Iterations inside the worker: each thread owns a disjoint row block,
  // so repeated SpMVs need no barrier (y entries are overwritten with
  // the same values each pass) and thread spawn cost is paid once.
  for (int it = 0; it < iterations; it++) {
    for (long long r = r0; r < r1; r++) {
      long long j = row_ptr[r];
      const long long end = row_ptr[r + 1];
      float acc = 0.0f;
#if defined(__AVX2__) && defined(__FMA__)
      // Vectorize along the row (8-wide gather + FMA) — only when the
      // row is long enough to amortize the setup + horizontal reduce
      // (short-row matrices like pwt otherwise pay it per row for
      // nothing).
      if (end - j >= 8) {
        __m256 vacc = _mm256_setzero_ps();
        for (; j + 8 <= end; j += 8) {
          __m256i idx =
              _mm256_loadu_si256(reinterpret_cast<const __m256i*>(col + j));
          __m256 xv = _mm256_i32gather_ps(x, idx, 4);
          __m256 vv = _mm256_loadu_ps(val + j);
          vacc = _mm256_fmadd_ps(vv, xv, vacc);
        }
        __m128 lo = _mm256_castps256_ps128(vacc);
        __m128 hi = _mm256_extractf128_ps(vacc, 1);
        __m128 s = _mm_add_ps(lo, hi);
        s = _mm_hadd_ps(s, s);
        s = _mm_hadd_ps(s, s);
        acc = _mm_cvtss_f32(s);
      }
#endif
      for (; j < end; j++) {
        acc += val[j] * x[col[j]];
      }
      y[r] = acc;
    }
  }
}

}  // namespace

extern "C" {

// y = A.x for CSR (f32). threads <= 1 runs the reference-style serial
// loop; otherwise rows are split into contiguous blocks across threads.
// iterations > 1 repeats the full SpMV (benchmark mode) back to back.
void csr_spmv_f32(const long long* row_ptr, const int32_t* col,
                  const float* val, const float* x, float* y,
                  long long nrows, int threads, int iterations) {
  if (threads <= 1) {
    csr_rows(row_ptr, col, val, x, y, 0, nrows, iterations);
    return;
  }
  long long blk = (nrows + threads - 1) / threads;
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; t++) {
    long long r0 = t * blk;
    long long r1 = r0 + blk < nrows ? r0 + blk : nrows;
    if (r0 >= r1) break;
    pool.emplace_back(csr_rows, row_ptr, col, val, x, y, r0, r1, iterations);
  }
  for (auto& th : pool) th.join();
}

// y = A.x for TJDS (f32): jagged-diagonal traversal with contiguous
// permuted-x reads (the reference hot loop main-cli.c:1013-1020, with
// the correct per-position x index — SURVEY.md B4). xp must already be
// the permuted x (xp[k] = x[perm[k]]).
//
// threads > 1: each thread owns a POSITION stripe of every diagonal
// (entries j with (j - lo) in its stripe scatter into a private partial
// y — rows overlap between stripes), then partials reduce into y.
void tjds_spmv_f32(const long long* start_pos, const int32_t* row_ind,
                   const float* val, const float* xp, float* y,
                   long long nrows, long long num_diags, int iterations,
                   int threads) {
  if (threads <= 1 || num_diags == 0) {
    for (int it = 0; it < iterations; it++) {
      for (long long r = 0; r < nrows; r++) y[r] = 0.0f;
      for (long long d = 0; d < num_diags; d++) {
        const long long lo = start_pos[d], hi = start_pos[d + 1];
        for (long long j = lo; j < hi; j++) {
          y[row_ind[j]] += val[j] * xp[j - lo];
        }
      }
    }
    return;
  }
  const long long width = start_pos[1] - start_pos[0];  // widest diagonal
  const long long stripe = (width + threads - 1) / threads;
  std::vector<std::vector<float>> partial(
      threads, std::vector<float>(nrows, 0.0f));
  auto worker = [&](int t) {
    const long long p0 = t * stripe;
    const long long p1 = p0 + stripe < width ? p0 + stripe : width;
    float* yp = partial[t].data();
    for (int it = 0; it < iterations; it++) {
      for (long long r = 0; r < nrows; r++) yp[r] = 0.0f;
      for (long long d = 0; d < num_diags; d++) {
        const long long lo = start_pos[d], hi = start_pos[d + 1];
        const long long jb = lo + p0;
        const long long je = lo + p1 < hi ? lo + p1 : hi;
        for (long long j = jb; j < je; j++) {
          yp[row_ind[j]] += val[j] * xp[j - lo];
        }
      }
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; t++) pool.emplace_back(worker, t);
  for (auto& th : pool) th.join();
  for (long long r = 0; r < nrows; r++) y[r] = 0.0f;
  for (int t = 0; t < threads; t++) {
    const float* yp = partial[t].data();
    for (long long r = 0; r < nrows; r++) y[r] += yp[r];
  }
}

}  // extern "C"
