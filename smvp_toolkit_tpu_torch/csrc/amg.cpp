// The aggregation pass of smoothed-aggregation AMG set-up
// (models/amg.py), in host C++.
//
// A copy of the JAX package's native/amg.cpp aggregate_pass, with the same
// C signature: greedy standard aggregation over a symmetric strength graph
// (CSR pattern, no diagonal). It mirrors the numpy pass
// models/amg.py:_aggregate_numpy pass for pass; the work is integer only,
// so the two give identical arrays. The pass is sequential by nature
// (pass 1 reads its own earlier assignments), so its interpreted loop
// would dominate the set-up at a million rows. ops/_build.py compiles it
// with the host compiler on first use.

extern "C" {

// agg[n] receives the aggregate id of each node; returns the count.
long long aggregate_pass(const long long* indptr,
                         const long long* indices,
                         long long n, long long* agg) {
  for (long long i = 0; i < n; ++i) agg[i] = -1;
  long long nxt = 0;
  // Pass 1: seed an aggregate wherever the whole strong neighbourhood
  // is untouched.
  for (long long i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    bool untouched = true;
    for (long long t = indptr[i]; t < indptr[i + 1]; ++t) {
      if (agg[indices[t]] != -1) {
        untouched = false;
        break;
      }
    }
    if (untouched) {
      agg[i] = nxt;
      for (long long t = indptr[i]; t < indptr[i + 1]; ++t)
        agg[indices[t]] = nxt;
      ++nxt;
    }
  }
  // Pass 2: attach leftovers to the first aggregated neighbour.
  for (long long i = 0; i < n; ++i) {
    if (agg[i] != -1) continue;
    for (long long t = indptr[i]; t < indptr[i + 1]; ++t) {
      const long long a = agg[indices[t]];
      if (a != -1) {
        agg[i] = a;
        break;
      }
    }
  }
  // Pass 3: singletons for whatever remains.
  for (long long i = 0; i < n; ++i)
    if (agg[i] == -1) agg[i] = nxt++;
  return nxt;
}

}  // extern "C"
