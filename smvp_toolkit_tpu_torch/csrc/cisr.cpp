// CISR slot-group scheduler of formats/cisr.py, in host C++.
//
// A copy of the JAX package's native/cisr.cpp with the same C signatures.
// Rows are consumed in order by `slot_count` channels (the reference's C
// scheduler, main-cli.c:542-612); each beat every active channel emits one
// nonzero of its current row, picking up the next unassigned row when its
// row is exhausted; idle channels emit padding. The Python loop in
// formats/cisr.py (use_native=False) is the reference semantics and this
// pass equals it element for element; ops/_build.py compiles it with the
// host compiler on first use.
//
// Unlike the reference, empty rows are handled correctly: they consume a
// row-length record and no beats (main-cli.c would emit the next row's
// first entry; SURVEY.md notes all its samples dodge this).

#include <cstdint>
#include <vector>

extern "C" {

// Phase 1: compute the number of slot groups (beats) for sizing.
// row_ptr: CSR row pointers (nrows+1). Returns beat count, or -1 on error.
long long cisr_num_groups(const long long* row_ptr, long long nrows,
                          int slot_count) {
  if (slot_count < 1) return -1;
  std::vector<long long> remaining(slot_count, 0);
  long long next_row = 0;
  long long beats = 0;
  auto pickup = [&](int s) -> bool {
    while (next_row < nrows) {
      long long r = next_row++;
      long long len = row_ptr[r + 1] - row_ptr[r];
      if (len > 0) {
        remaining[s] = len;
        return true;
      }
    }
    return false;
  };
  int active = 0;
  std::vector<char> alive(slot_count, 0);
  for (int s = 0; s < slot_count; s++) {
    alive[s] = pickup(s) ? 1 : 0;
    if (alive[s]) active++;
  }
  while (active > 0) {
    beats++;
    for (int s = 0; s < slot_count; s++) {
      if (!alive[s]) continue;
      if (--remaining[s] == 0) {
        alive[s] = pickup(s) ? 1 : 0;
        if (!alive[s]) active--;
      }
    }
  }
  return beats;
}

// Phase 2: fill the schedule arrays.
// Inputs: CSR (row_ptr int64[nrows+1], col int32[nnz], val f64[nnz]).
// Outputs (caller-allocated, beats x slot_count, row-major):
//   vals f64, cols int32, row_of int32 (-1 = idle);
//   row_lengths int32[nrows] (pickup order = row order).
// Returns 0 on success.
int cisr_schedule(const long long* row_ptr, const int32_t* col,
                  const double* val, long long nrows, int slot_count,
                  long long beats, double* out_val, int32_t* out_col,
                  int32_t* out_row, int32_t* row_lengths) {
  if (slot_count < 1) return 1;
  for (long long r = 0; r < nrows; r++)
    row_lengths[r] = static_cast<int32_t>(row_ptr[r + 1] - row_ptr[r]);

  std::vector<long long> cursor(slot_count, 0), remaining(slot_count, 0),
      rowof(slot_count, -1);
  long long next_row = 0;
  auto pickup = [&](int s) -> bool {
    while (next_row < nrows) {
      long long r = next_row++;
      long long len = row_ptr[r + 1] - row_ptr[r];
      if (len > 0) {
        cursor[s] = row_ptr[r];
        remaining[s] = len;
        rowof[s] = r;
        return true;
      }
    }
    return false;
  };
  std::vector<char> alive(slot_count, 0);
  int active = 0;
  for (int s = 0; s < slot_count; s++) {
    alive[s] = pickup(s) ? 1 : 0;
    if (alive[s]) active++;
  }
  long long b = 0;
  while (active > 0 && b < beats) {
    for (int s = 0; s < slot_count; s++) {
      long long idx = b * slot_count + s;
      if (alive[s]) {
        out_val[idx] = val[cursor[s]];
        out_col[idx] = col[cursor[s]];
        out_row[idx] = static_cast<int32_t>(rowof[s]);
        cursor[s]++;
        if (--remaining[s] == 0) {
          alive[s] = pickup(s) ? 1 : 0;
          if (!alive[s]) active--;
        }
      } else {
        out_val[idx] = 0.0;
        out_col[idx] = 0;
        out_row[idx] = -1;
      }
    }
    b++;
  }
  return (active == 0) ? 0 : 2;  // 2 = beats undersized
}

}  // extern "C"
