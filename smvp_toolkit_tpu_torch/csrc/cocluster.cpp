// Joint row x column co-clustering refinement for the SELL-T1 layout.
//
// A copy of the JAX package's native co-clustering pass, with the same C
// signatures (cocluster_refine, cocluster_objective) and the same integer
// arithmetic, so both give the same maps and objectives element for
// element. ops/_build.py compiles it with the host compiler; ops/cocluster.py
// loads it through ctypes and raises when it cannot be built.
//
// The SELL-T1 plan (ops/sell_plan.py) spends one sublane per
// (row-slice, col-tile, dup) cell layer: a slice needs, for every
// column tile t, max over its rows r of count(r, t) sublanes. Total
// sublanes S therefore depend ONLY on the row->slice and col->tile
// assignments:
//
//     S_true = sum over cells (s, t) of  max_{r in s} count(r, t)
//
// and occupancy = nnz / (S * 128) is the linear factor of the kernels'
// slot rate. This is the joint optimizer: greedy alternating
// column->tile / row->slice moves with exact incremental objective
// updates.
//
// S is a sum of cell maxima, so single moves mostly sit on plateaus
// (dS == 0 unless the unique max-holder moves). The search therefore
// keeps a strictly-decreasing LEXICOGRAPHIC objective (S, Pot):
//
//     Pot = sum_{r,t} count(r,t)^2  +  alpha * #live cells
//
// Plateau moves (dS == 0, dPot < 0) flatten count imbalance and
// consolidate cells, which unlocks later max reductions; lexicographic
// descent cannot cycle. Moves are capacity-bounded (<= 128 per group)
// and locality-bounded (+- radius groups) so the per-chunk tile/slice
// windows of the plan stay narrow; row moves also consider the slices of
// column-sharing rows (support similarity).
//
// Accelerates the capability of the reference hot loop
// (main-cli.c:410-416); the algorithm itself has no reference analog.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

using std::int64_t;
using std::vector;

constexpr int kLanes = 128;

// Per-cell count histogram: hist[k] = #rows with exactly k entries in
// this (slice, tile) cell (k >= 1). mx = current max (the cell's
// sublane cost). live = #rows present.
struct Cell {
  vector<int32_t> hist;
  int32_t mx = 0;
  int32_t live = 0;
  int64_t sum = 0;  // total entries in the cell
  int64_t sq = 0;   // sum of per-row counts squared

  // Live-lane slack: dead slots among live sublane positions.
  int64_t slack() const { return (int64_t)mx * live - sum; }
};

struct Delta {
  int64_t dS = 0;
  int64_t dPot = 0;
  // ws > 0: combined scalar objective ws*S + Pot (lets consolidation
  // gains pay for transient S increases — the escape hatch for row
  // regrouping, whose win only materializes after several rows merge).
  // ws <= 0: strict lexicographic (S, Pot) descent (the polish mode).
  bool better(int64_t ws) const {
    if (ws > 0) return ws * dS + dPot < 0;
    return dS < 0 || (dS == 0 && dPot < 0);
  }
  bool better_than(const Delta& o, int64_t ws) const {
    if (ws > 0) return ws * dS + dPot < ws * o.dS + o.dPot;
    return dS < o.dS || (dS == o.dS && dPot < o.dPot);
  }
};

struct State {
  int64_t n = 0, m = 0, nnz = 0;
  int64_t n_slices = 0, n_tiles = 0;
  int64_t alpha = 16;  // live-cell weight in Pot
  int pot_kind = 0;    // 0: sum of count^2; 1: live-lane slack
  int cap = kLanes;

  vector<int64_t> col_ptr, col_rows;  // CSR by column
  vector<int64_t> row_ptr, row_cols;  // CSR by row

  vector<int32_t> slice_of;  // per row
  vector<int32_t> tile_of;   // per col
  vector<int32_t> slice_size, tile_size;

  // cnt(r, t): per-row sparse profile (tile -> count).
  vector<vector<std::pair<int32_t, int32_t>>> prof;

  std::unordered_map<int64_t, Cell> cells;
  int64_t S = 0;
  int64_t Pot = 0;

  Cell& cell(int64_t s, int64_t t) { return cells[s * n_tiles + t]; }

  int prof_get(int64_t r, int32_t t) const {
    for (auto& p : prof[r])
      if (p.first == t) return p.second;
    return 0;
  }

  void prof_add(int64_t r, int32_t t, int32_t d) {
    auto& v = prof[r];
    for (size_t i = 0; i < v.size(); i++) {
      if (v[i].first == t) {
        v[i].second += d;
        if (v[i].second == 0) {
          v[i] = v.back();
          v.pop_back();
        }
        return;
      }
    }
    v.emplace_back(t, d);
  }

  // Cell's contribution to the plateau potential, from its fields.
  int64_t pot_cell(const Cell& cl) const {
    if (cl.live == 0) return 0;
    return (pot_kind == 1 ? cl.slack() : cl.sq) + alpha;
  }

  // One row's count in cell: k -> k+1 (k==0: row enters).
  void add_unit(Cell& cl, int k, Delta& d) {
    int64_t pre = pot_cell(cl);
    if (k + 1 >= (int)cl.hist.size()) cl.hist.resize(k + 2, 0);
    if (k > 0) {
      cl.hist[k]--;
    } else {
      cl.live++;
    }
    cl.hist[k + 1]++;
    cl.sum += 1;
    cl.sq += 2 * k + 1;
    if (k + 1 > cl.mx) {
      cl.mx = k + 1;
      d.dS += 1;
      S += 1;
    }
    int64_t dp = pot_cell(cl) - pre;
    d.dPot += dp;
    Pot += dp;
  }

  // One row's count in cell: k -> k-1 (k==1: row leaves).
  void remove_unit(Cell& cl, int k, Delta& d) {
    int64_t pre = pot_cell(cl);
    cl.hist[k]--;
    if (k > 1) {
      cl.hist[k - 1]++;
    } else {
      cl.live--;
    }
    cl.sum -= 1;
    cl.sq -= 2 * k - 1;
    if (k == cl.mx && cl.hist[k] == 0) {
      int old = cl.mx;
      while (cl.mx > 0 && cl.hist[cl.mx] == 0) cl.mx--;
      d.dS += cl.mx - old;
      S += cl.mx - old;
    }
    int64_t dp = pot_cell(cl) - pre;
    d.dPot += dp;
    Pot += dp;
  }

  // Move column c to tile t1 (caller checks capacity).
  Delta move_col(int64_t c, int32_t t1) {
    int32_t t0 = tile_of[c];
    Delta d;
    for (int64_t i = col_ptr[c]; i < col_ptr[c + 1]; i++) {
      int64_t r = col_rows[i];
      int32_t s = slice_of[r];
      remove_unit(cell(s, t0), prof_get(r, t0), d);
      prof_add(r, t0, -1);
      add_unit(cell(s, t1), prof_get(r, t1), d);
      prof_add(r, t1, +1);
    }
    tile_of[c] = t1;
    tile_size[t0]--;
    tile_size[t1]++;
    return d;
  }

  // Move row r to slice s1 (whole profile moves with the row).
  Delta move_row(int64_t r, int32_t s1) {
    int32_t s0 = slice_of[r];
    Delta d;
    for (auto& p : prof[r]) {
      int64_t k = p.second;
      Cell& c0 = cell(s0, p.first);
      int64_t pre0 = pot_cell(c0);
      c0.hist[k]--;
      c0.live--;
      c0.sum -= k;
      c0.sq -= k * k;
      if (k == c0.mx && c0.hist[k] == 0) {
        int old = c0.mx;
        while (c0.mx > 0 && c0.hist[c0.mx] == 0) c0.mx--;
        d.dS += c0.mx - old;
        S += c0.mx - old;
      }
      int64_t dp = pot_cell(c0) - pre0;
      Cell& c1 = cell(s1, p.first);
      int64_t pre1 = pot_cell(c1);
      if (k >= (int64_t)c1.hist.size()) c1.hist.resize(k + 1, 0);
      c1.live++;
      c1.hist[k]++;
      c1.sum += k;
      c1.sq += k * k;
      if (k > c1.mx) {
        d.dS += k - c1.mx;
        S += k - c1.mx;
        c1.mx = k;
      }
      dp += pot_cell(c1) - pre1;
      d.dPot += dp;
      Pot += dp;
    }
    slice_of[r] = s1;
    slice_size[s0]--;
    slice_size[s1]++;
    return d;
  }

  void prune_dead_cells() {
    for (auto it = cells.begin(); it != cells.end();)
      it = (it->second.live == 0) ? cells.erase(it) : std::next(it);
  }
};

void build_state(State& st, const int64_t* rows, const int64_t* cols,
                 int64_t nnz, int64_t n, int64_t m,
                 const int32_t* row_init, const int32_t* col_init,
                 int64_t n_slices, int64_t n_tiles) {
  st.n = n;
  st.m = m;
  st.nnz = nnz;
  st.n_slices = n_slices;
  st.n_tiles = n_tiles;
  st.slice_of.assign(row_init, row_init + n);
  st.tile_of.assign(col_init, col_init + m);
  st.slice_size.assign(n_slices, 0);
  st.tile_size.assign(n_tiles, 0);
  for (int64_t r = 0; r < n; r++) st.slice_size[st.slice_of[r]]++;
  for (int64_t c = 0; c < m; c++) st.tile_size[st.tile_of[c]]++;

  st.col_ptr.assign(m + 1, 0);
  st.row_ptr.assign(n + 1, 0);
  for (int64_t i = 0; i < nnz; i++) {
    st.col_ptr[cols[i] + 1]++;
    st.row_ptr[rows[i] + 1]++;
  }
  for (int64_t c = 0; c < m; c++) st.col_ptr[c + 1] += st.col_ptr[c];
  for (int64_t r = 0; r < n; r++) st.row_ptr[r + 1] += st.row_ptr[r];
  st.col_rows.resize(nnz);
  st.row_cols.resize(nnz);
  {
    vector<int64_t> w(st.col_ptr.begin(), st.col_ptr.end() - 1);
    vector<int64_t> wr(st.row_ptr.begin(), st.row_ptr.end() - 1);
    for (int64_t i = 0; i < nnz; i++) {
      st.col_rows[w[cols[i]]++] = rows[i];
      st.row_cols[wr[rows[i]]++] = cols[i];
    }
  }

  st.prof.assign(n, {});
  st.cells.reserve(nnz / 8 + 64);
  st.S = 0;
  st.Pot = 0;
  for (int64_t r = 0; r < n; r++) {
    int64_t lo = st.row_ptr[r], hi = st.row_ptr[r + 1];
    if (lo == hi) continue;
    auto& v = st.prof[r];
    for (int64_t i = lo; i < hi; i++) {
      int32_t t = st.tile_of[st.row_cols[i]];
      bool found = false;
      for (auto& p : v)
        if (p.first == t) {
          p.second++;
          found = true;
          break;
        }
      if (!found) v.emplace_back(t, 1);
    }
    int32_t s = st.slice_of[r];
    for (auto& p : v) {
      Cell& cl = st.cell(s, p.first);
      if (p.second >= (int)cl.hist.size()) cl.hist.resize(p.second + 1, 0);
      cl.live++;
      cl.hist[p.second]++;
      cl.sum += p.second;
      cl.sq += (int64_t)p.second * p.second;
      if (p.second > cl.mx) {
        st.S += p.second - cl.mx;
        cl.mx = p.second;
      }
    }
  }
  for (auto& kv : st.cells) st.Pot += st.pot_cell(kv.second);
}

int64_t col_pass(State& st, int radius, int64_t ws) {
  int64_t improved = 0;
  for (int64_t c = 0; c < st.m; c++) {
    if (st.col_ptr[c] == st.col_ptr[c + 1]) continue;
    int32_t t0 = st.tile_of[c];
    int32_t best_t = t0;
    Delta best;
    for (int dt = -radius; dt <= radius; dt++) {
      int32_t t1 = t0 + dt;
      if (dt == 0 || t1 < 0 || t1 >= st.n_tiles) continue;
      if (st.tile_size[t1] >= st.cap) continue;
      Delta d = st.move_col(c, t1);
      if (d.better(ws) && d.better_than(best, ws)) {
        best = d;
        best_t = t1;
      }
      st.move_col(c, t0);  // revert
    }
    if (best_t != t0) {
      st.move_col(c, best_t);
      improved++;
    }
  }
  return improved;
}

int64_t row_pass(State& st, int radius, int64_t ws) {
  int64_t improved = 0;
  vector<int32_t> cands;
  for (int64_t r = 0; r < st.n; r++) {
    if (st.prof[r].empty()) continue;
    int32_t s0 = st.slice_of[r];
    // Candidates: nearby slices + slices of column-sharing rows
    // (support similarity — the fragmentation fix for scattered
    // matrices where similar rows are far apart in natural order).
    cands.clear();
    for (int ds = -radius; ds <= radius; ds++) {
      int32_t s1 = s0 + ds;
      if (ds != 0 && s1 >= 0 && s1 < st.n_slices) cands.push_back(s1);
    }
    int budget = 48;  // neighbor-scan cap per row
    for (int64_t i = st.row_ptr[r];
         i < st.row_ptr[r + 1] && budget > 0; i++) {
      int64_t c = st.row_cols[i];
      int64_t lo = st.col_ptr[c], hi = st.col_ptr[c + 1];
      // Dense columns would flood the candidate list; sample ends.
      int64_t step = std::max<int64_t>(1, (hi - lo) / 8);
      for (int64_t j = lo; j < hi && budget > 0; j += step, budget--) {
        int32_t s1 = st.slice_of[st.col_rows[j]];
        if (s1 != s0) cands.push_back(s1);
      }
    }
    std::sort(cands.begin(), cands.end());
    cands.erase(std::unique(cands.begin(), cands.end()), cands.end());

    int32_t best_s = s0;
    Delta best;
    for (int32_t s1 : cands) {
      if (st.slice_size[s1] >= st.cap) continue;
      Delta d = st.move_row(r, s1);
      if (d.better(ws) && d.better_than(best, ws)) {
        best = d;
        best_s = s1;
      }
      st.move_row(r, s0);  // revert
    }
    if (best_s != s0) {
      st.move_row(r, best_s);
      improved++;
    }
  }
  return improved;
}

}  // namespace

extern "C" {

// Refine row->slice and col->tile assignments in place.
//
//   rows, cols:       nnz COO coordinates
//   row_assign:       n int32, initial slice per row (mutated)
//   col_assign:       m int32, initial tile per col (mutated)
//   n_slices/n_tiles: group counts (capacity 128 each)
//   passes:           max alternating pass pairs
//   col_radius/row_radius: locality bound for moves (groups);
//                     0 disables that side
//   alpha:            live-cell weight in the plateau potential
//   pot_kind:         0 = sum-of-count^2 potential (flattening),
//                     1 = live-lane slack potential (mx*live - sum)
//
// Returns the final objective S_true (total sublanes), or -1 on bad
// arguments. Deterministic (fixed scan order, first-best moves).
long long cocluster_refine(const int64_t* rows, const int64_t* cols,
                           long long nnz, long long n, long long m,
                           int32_t* row_assign, int32_t* col_assign,
                           long long n_slices, long long n_tiles,
                           int passes, int col_radius, int row_radius,
                           long long alpha, int pot_kind, long long s_weight,
                           long long* out_moves) {
  if (nnz < 0 || n <= 0 || m <= 0 || n_slices <= 0 || n_tiles <= 0)
    return -1;
  for (int64_t i = 0; i < nnz; i++)
    if (rows[i] < 0 || rows[i] >= n || cols[i] < 0 || cols[i] >= m)
      return -1;
  for (int64_t i = 0; i < n; i++)
    if (row_assign[i] < 0 || row_assign[i] >= n_slices) return -1;
  for (int64_t i = 0; i < m; i++)
    if (col_assign[i] < 0 || col_assign[i] >= n_tiles) return -1;

  State st;
  st.alpha = alpha;
  st.pot_kind = pot_kind;
  build_state(st, rows, cols, nnz, n, m, row_assign, col_assign,
              n_slices, n_tiles);

  int64_t total_moves = 0;
  for (int p = 0; p < passes; p++) {
    int64_t moved = 0;
    if (col_radius > 0) moved += col_pass(st, col_radius, s_weight);
    if (row_radius > 0) moved += row_pass(st, row_radius, s_weight);
    st.prune_dead_cells();
    total_moves += moved;
    if (moved == 0) break;
  }
  if (s_weight > 0) {
    // Combined-objective descent can end with S above its local
    // minimum (Pot bought small S increases); polish with strict
    // lexicographic passes until S-fixpoint.
    for (int p = 0; p < passes; p++) {
      int64_t moved = 0;
      if (col_radius > 0) moved += col_pass(st, col_radius, 0);
      if (row_radius > 0) moved += row_pass(st, row_radius, 0);
      st.prune_dead_cells();
      total_moves += moved;
      if (moved == 0) break;
    }
  }

  std::memcpy(row_assign, st.slice_of.data(), n * sizeof(int32_t));
  std::memcpy(col_assign, st.tile_of.data(), m * sizeof(int32_t));
  if (out_moves) *out_moves = total_moves;
  return st.S;
}

// Objective only (no refinement): exact S_true for an assignment.
long long cocluster_objective(const int64_t* rows, const int64_t* cols,
                              long long nnz, long long n, long long m,
                              const int32_t* row_assign,
                              const int32_t* col_assign,
                              long long n_slices, long long n_tiles) {
  // Same validation as cocluster_refine: out-of-range coordinates or
  // assignments must return an error, not corrupt the heap.
  if (nnz < 0 || n <= 0 || m <= 0 || n_slices <= 0 || n_tiles <= 0)
    return -1;
  for (int64_t i = 0; i < nnz; i++)
    if (rows[i] < 0 || rows[i] >= n || cols[i] < 0 || cols[i] >= m)
      return -1;
  for (int64_t i = 0; i < n; i++)
    if (row_assign[i] < 0 || row_assign[i] >= n_slices) return -1;
  for (int64_t i = 0; i < m; i++)
    if (col_assign[i] < 0 || col_assign[i] >= n_tiles) return -1;
  State st;
  build_state(st, rows, cols, nnz, n, m, row_assign, col_assign,
              n_slices, n_tiles);
  return st.S;
}

}  // extern "C"
