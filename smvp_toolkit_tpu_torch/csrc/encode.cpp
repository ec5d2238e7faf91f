// Host COO->CSR / COO->TJDS encode orders of formats/encode_native.py.
//
// A copy of the JAX package's native/encode.cpp with the same C
// signatures. Every encode sort key is a bounded integer (row, column,
// jagged-diagonal id), so the whole encode is a chain of STABLE COUNTING
// SORTS: O(nnz + nrows + ncols) total, no comparisons.
//
// These functions compute only the *permutation* (plus the integer
// side-products: row_ptr / start_pos / perm / offsets). The Python
// wrapper applies the permutation to the value tensor (any dtype) and
// assembles the dataclasses, so results are bit-identical to the torch
// sort encoders of formats/csr.py and formats/tjds.py (same stable order,
// same sentinel handling).
//
// Reference parity: the C toolkit encodes CSR with a comparison qsort
// (main-cli.c:340-365) and TJDS with qsort + per-column scans
// (main-cli.c:752-967); both are O(nnz log nnz) with AoS shuffles.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

using i32 = int32_t;
using i64 = long long;

// Stable counting sort of `order` (indices) by key(order[j]).
// keys must lie in [0, nkeys). Scratch `tmp` has the same length.
template <class KeyFn>
void counting_pass(std::vector<i64>& order, std::vector<i64>& tmp,
                   i64 nkeys, KeyFn key) {
  std::vector<i64> count(static_cast<size_t>(nkeys) + 1, 0);
  for (i64 j : order) ++count[key(j) + 1];
  for (i64 k = 0; k < nkeys; ++k) count[k + 1] += count[k];
  for (i64 j : order) tmp[count[key(j)]++] = j;
  order.swap(tmp);
}

}  // namespace

extern "C" {

// CSR: stable (row, col) sort of COO triplets + row_ptr prefix build.
// Padding entries (j >= nnz) are treated as (row=nrows, col=0) — the
// same sentinel forcing as the torch encoder — and land after all real
// entries. out_order: i64[npad]; out_row_ptr: i32[nrows+1].
void csr_encode_order(const i32* rows, const i32* cols, i64 nnz, i64 npad,
                      i64 nrows, i64 /*ncols*/, i64* out_order,
                      i32* out_row_ptr) {
  std::vector<i64> order(static_cast<size_t>(npad));
  std::vector<i64> tmp(static_cast<size_t>(npad));
  for (i64 j = 0; j < npad; ++j) order[j] = j;

  // Secondary key first (stable lexsort: last pass is the primary key).
  i64 maxcol = 0;
  for (i64 j = 0; j < nnz; ++j) maxcol = std::max<i64>(maxcol, cols[j]);
  counting_pass(order, tmp, maxcol + 1,
                [&](i64 j) -> i64 { return j < nnz ? cols[j] : 0; });
  counting_pass(order, tmp, nrows + 1,
                [&](i64 j) -> i64 { return j < nnz ? rows[j] : nrows; });

  // row_ptr[i] = #real entries with row < i (padding rows == nrows fall
  // in the final bucket, which row_ptr[nrows] == nnz excludes).
  std::vector<i64> rcount(static_cast<size_t>(nrows) + 1, 0);
  for (i64 j = 0; j < nnz; ++j) ++rcount[rows[j]];
  i64 acc = 0;
  for (i64 i = 0; i <= nrows; ++i) {
    out_row_ptr[i] = static_cast<i32>(acc);
    if (i < nrows) acc += rcount[i];
  }
  if (npad > 0) std::memcpy(out_order, order.data(), sizeof(i64) * npad);
}

// TJDS: column permutation by descending column length, vertical
// compression (position-within-column ordered by row), pack by
// (jagged diagonal, permuted column). Mirrors the torch encoder of
// formats/tjds.py exactly, including sentinel handling:
// padding entries get new_col == ncols and diag == diag_bound.
// Returns num_diags (the true max column length).
// out_order: i64[npad]  (final permutation of original entry indices)
// out_offsets: i32[npad] (position within diagonal; 0 for padding)
// out_perm: i32[ncols]   (original column at permuted position k)
// out_start_pos: i32[diag_bound + 1]
i64 tjds_encode_order(const i32* rows, const i32* cols, i64 nnz, i64 npad,
                      i64 nrows, i64 ncols, i64 diag_bound, i64* out_order,
                      i32* out_offsets, i32* out_perm, i32* out_start_pos) {
  // Phase 1 — column lengths.
  std::vector<i64> counts(static_cast<size_t>(ncols), 0);
  for (i64 j = 0; j < nnz; ++j) ++counts[cols[j]];
  i64 num_diags = 0;
  for (i64 c = 0; c < ncols; ++c) num_diags = std::max(num_diags, counts[c]);

  // Phase 2 — permutation by (length desc, column id asc).
  std::vector<i32> perm(static_cast<size_t>(ncols));
  for (i64 c = 0; c < ncols; ++c) perm[c] = static_cast<i32>(c);
  std::stable_sort(perm.begin(), perm.end(), [&](i32 a, i32 b) {
    if (counts[a] != counts[b]) return counts[a] > counts[b];
    return a < b;
  });
  std::vector<i32> rank(static_cast<size_t>(ncols) + 1);
  for (i64 k = 0; k < ncols; ++k) rank[perm[k]] = static_cast<i32>(k);
  rank[ncols] = static_cast<i32>(ncols);

  auto new_col = [&](i64 j) -> i64 {
    return j < nnz ? rank[cols[j]] : ncols;
  };

  // Phase 3 — stable sort by (new_col, row): row pass then column pass.
  std::vector<i64> order(static_cast<size_t>(npad));
  std::vector<i64> tmp(static_cast<size_t>(npad));
  for (i64 j = 0; j < npad; ++j) order[j] = j;
  counting_pass(order, tmp, nrows + 1,
                [&](i64 j) -> i64 { return j < nnz ? rows[j] : nrows; });
  counting_pass(order, tmp, ncols + 1, new_col);

  // diag id = position - column start (columns are contiguous runs now);
  // padding collapses to the diag_bound bucket.
  std::vector<i32> diag(static_cast<size_t>(npad));
  std::vector<i32> nc1(static_cast<size_t>(npad));
  i64 run_start = 0;
  for (i64 k = 0; k < npad; ++k) {
    i64 nc = new_col(order[k]);
    nc1[k] = static_cast<i32>(nc);
    if (k > 0 && nc != nc1[k - 1]) run_start = k;
    diag[k] = nc >= ncols ? static_cast<i32>(diag_bound)
                          : static_cast<i32>(k - run_start);
  }

  // Phase 4 — stable sort positions by diag; compose the final order.
  std::vector<i64> pos(static_cast<size_t>(npad));
  std::vector<i64> ptmp(static_cast<size_t>(npad));
  for (i64 k = 0; k < npad; ++k) pos[k] = k;
  counting_pass(pos, ptmp, diag_bound + 1,
                [&](i64 k) -> i64 { return diag[k]; });

  std::vector<i64> dcount(static_cast<size_t>(diag_bound) + 2, 0);
  for (i64 k = 0; k < npad; ++k) ++dcount[diag[k] + 1];
  for (i64 d = 0; d <= diag_bound; ++d) dcount[d + 1] += dcount[d];
  for (i64 d = 0; d <= diag_bound; ++d)
    out_start_pos[d] = static_cast<i32>(std::min(dcount[d], nnz));

  for (i64 m = 0; m < npad; ++m) {
    i64 k = pos[m];
    out_order[m] = order[k];
    out_offsets[m] = m < nnz ? nc1[k] : 0;
  }
  if (ncols > 0) std::memcpy(out_perm, perm.data(), sizeof(i32) * ncols);
  return num_diags;
}

}  // extern "C"
