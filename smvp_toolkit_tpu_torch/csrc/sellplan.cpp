// The SELL-T1 planner's sort-and-assign pass of ops/sell_plan.py, in host
// C++.
//
// A copy of the JAX package's native/sellplan.cpp with the same C
// signatures. The numpy planner needs two full 64-bit sorts (lexsort +
// unique) plus several elementwise passes over every entry; this pass does
// ONE threaded sort plus linear scans and gives the same planes element
// for element (ops/sell_plan.py runs the shared windowing tail on either).
// ops/_build.py compiles it with the host compiler and -pthread.
//
// Key insight vs the numpy flow: sorting entries by (tile, slice, lane)
// makes sublane ids assignable in a single pass — within a (tile, slice)
// cell the k-th duplicate of any lane belongs to sublane
// cell_base + k, and cells are visited in exactly the tile-major order
// the plan wants. The separate (tile, slice, dup) sort that numpy's
// np.unique performs disappears.
//
// ABI: an opaque handle carries the sorted state between the size query
// and the fill call (the sublane count is data-dependent).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <new>
#include <thread>
#include <vector>

namespace {

constexpr int kLanes = 128;

struct Entry {
  uint64_t key;  // tile<<38 | slice<<7 | lane  (tile-major order)
  uint32_t idx;  // original triplet index
  // idx tie-break = stable order: duplicate (row, col-tile) entries keep
  // their triplet order across dup levels, bit-identical to the numpy
  // planner's stable lexsort.
  bool operator<(const Entry& o) const {
    return key != o.key ? key < o.key : idx < o.idx;
  }
};

struct PlanState {
  std::vector<Entry> entries;          // sorted
  std::vector<int32_t> sub_of;         // sublane id per sorted entry
  std::vector<int64_t> sub_tile;       // tile per sublane
  std::vector<int64_t> sub_slice;      // slice per sublane
  int64_t n_sublanes = 0;
  int64_t max_dup = 0;
};

// Sort `v` with `nt` threads: per-block std::sort + pairwise merges.
void parallel_sort(std::vector<Entry>& v, int nt) {
  const size_t n = v.size();
  if (nt < 2 || n < (1u << 16)) {
    std::sort(v.begin(), v.end());
    return;
  }
  // Power-of-two block count for a clean merge tree.
  int blocks = 1;
  while (blocks * 2 <= nt) blocks *= 2;
  std::vector<size_t> bounds(blocks + 1);
  for (int b = 0; b <= blocks; b++) bounds[b] = n * b / blocks;
  {
    std::vector<std::thread> pool;
    for (int b = 0; b < blocks; b++)
      pool.emplace_back([&, b] {
        std::sort(v.begin() + bounds[b], v.begin() + bounds[b + 1]);
      });
    for (auto& t : pool) t.join();
  }
  for (int width = 1; width < blocks; width *= 2) {
    std::vector<std::thread> pool;
    for (int b = 0; b + width < blocks; b += 2 * width)
      pool.emplace_back([&, b] {
        std::inplace_merge(v.begin() + bounds[b],
                           v.begin() + bounds[b + width],
                           v.begin() + bounds[std::min(b + 2 * width, blocks)]);
      });
    for (auto& t : pool) t.join();
  }
}

}  // namespace

extern "C" {

// Phase 1: sort + assign sublanes. Returns an opaque handle (NULL on
// overflow of the key fields). rows/cols are int64 triplet indices.
//   key fields: lane 7 bits, slice 31 bits, tile 26 bits -> 64 total.
void* sell_plan_create(const int64_t* rows, const int64_t* cols,
                       int64_t nnz, int64_t nrows, int64_t ncols,
                       int threads) {
  // Field-width guard (tile 26 bits, slice 31 bits): bound by the
  // declared shape, which the caller has validated indices against.
  if (((ncols > 0 ? (ncols - 1) >> 7 : 0) >= (int64_t(1) << 26)) ||
      ((nrows > 0 ? (nrows - 1) >> 7 : 0) >= (int64_t(1) << 31))) {
    return nullptr;
  }
  auto* st = new (std::nothrow) PlanState();
  if (!st) return nullptr;
  st->entries.resize(nnz);
  {
    std::vector<std::thread> pool;
    int nt = threads > 1 ? threads : 1;
    for (int t = 0; t < nt; t++)
      pool.emplace_back([&, t] {
        const int64_t lo = nnz * t / nt, hi = nnz * (t + 1) / nt;
        for (int64_t i = lo; i < hi; i++) {
          const uint64_t slice = static_cast<uint64_t>(rows[i]) >> 7;
          const uint64_t lane = static_cast<uint64_t>(rows[i]) & 127u;
          const uint64_t tile = static_cast<uint64_t>(cols[i]) >> 7;
          st->entries[i].key = (tile << 38) | (slice << 7) | lane;
          st->entries[i].idx = static_cast<uint32_t>(i);
        }
      });
    for (auto& t : pool) t.join();
  }
  parallel_sort(st->entries, threads);

  // Single pass: dup = run index within (cell, lane); cell change starts
  // a fresh base; sublane id = cell_base + dup. Cells appear tile-major,
  // so ids come out already in the plan's sublane order.
  st->sub_of.resize(nnz);
  int64_t base = 0;        // first sublane id of the current cell
  int64_t cell_width = 0;  // sublanes used so far by the current cell
  int64_t dup = 0;
  uint64_t prev_cell = ~0ull, prev_key = ~0ull;
  for (int64_t i = 0; i < nnz; i++) {
    const uint64_t key = st->entries[i].key;
    const uint64_t cell = key >> 7;  // (tile, slice)
    if (cell != prev_cell) {
      base += cell_width;
      cell_width = 0;
      dup = 0;
      prev_cell = cell;
    } else if (key == prev_key) {
      dup++;
    } else {
      dup = 0;
    }
    prev_key = key;
    if (dup + 1 > cell_width) cell_width = dup + 1;
    const int64_t sub = base + dup;
    st->sub_of[i] = static_cast<int32_t>(sub);
    if (sub >= static_cast<int64_t>(st->sub_tile.size())) {
      st->sub_tile.resize(sub + 1);
      st->sub_slice.resize(sub + 1);
    }
    st->sub_tile[sub] = static_cast<int64_t>(cell >> 31);
    st->sub_slice[sub] = static_cast<int64_t>(cell & ((1ull << 31) - 1));
    if (dup > st->max_dup) st->max_dup = dup;
  }
  st->n_sublanes = base + cell_width;
  return st;
}

int64_t sell_plan_sublanes(void* handle) {
  return static_cast<PlanState*>(handle)->n_sublanes;
}

int64_t sell_plan_max_dup(void* handle) {
  return static_cast<PlanState*>(handle)->max_dup;
}

// Phase 2: fill the packed planes. Caller allocates:
//   vals_out   f32[S_pad * 128]     (zero-initialized)
//   lidx_out   i32[S_pad * 128]     (zero-initialized)
//   tile_out   i64[S_pad]           (filled: -1 for padding sublanes)
//   slice_out  i64[S_pad]           (filled: 0 for padding)
// with S_pad >= n_sublanes. cols/vals are the original triplets.
void sell_plan_fill(void* handle, const int64_t* cols, const float* vals,
                    int64_t s_pad, float* vals_out, int32_t* lidx_out,
                    int64_t* tile_out, int64_t* slice_out) {
  auto* st = static_cast<PlanState*>(handle);
  const int64_t nnz = static_cast<int64_t>(st->entries.size());
  for (int64_t i = 0; i < nnz; i++) {
    const uint32_t j = st->entries[i].idx;
    const int64_t sub = st->sub_of[i];
    const int64_t lane = static_cast<int64_t>(st->entries[i].key & 127u);
    vals_out[sub * kLanes + lane] = vals[j];
    lidx_out[sub * kLanes + lane] = static_cast<int32_t>(cols[j] & 127);
  }
  const int64_t S = st->n_sublanes;
  for (int64_t s = 0; s < S; s++) {
    tile_out[s] = st->sub_tile[s];
    slice_out[s] = st->sub_slice[s];
  }
  // Dead padding sublanes adopt the last real tile (keeps per-chunk
  // windows tight), matching the numpy planner.
  const int64_t last_tile = S > 0 ? st->sub_tile[S - 1] : 0;
  for (int64_t s = S; s < s_pad; s++) {
    tile_out[s] = last_tile;
    slice_out[s] = 0;
  }
}

void sell_plan_free(void* handle) { delete static_cast<PlanState*>(handle); }

}  // extern "C"
