// The IC(0) factorization pass of ops/ilu.py, in host C++.
//
// A copy of the JAX package's native/ilu.cpp ic0_pass, with the same C
// signature. It mirrors the numpy pass ops/ilu.py:_ic0_pass operation for
// operation (same elimination order, same sequential accumulation), so the
// two produce bit-identical arrays; ops/_build.py compiles it with the host
// compiler and -ffp-contract=off, so no multiply-add is fused into one
// rounding. The Python caller (ops/ilu.py:ic0) keeps the Manteuffel shift
// ladder and the acceptance test; only the elimination lives here, the
// part whose interpreted loop would dominate a factorization at the HPCG
// 104³ size.
//
// Sparse row lookups use a marker array: pos[col] holds the in-row slot
// while a row is active (-1 otherwise) and only touched entries are reset,
// so a pass is O(sum_i row_i · coupled-row length) with O(1) lookups.

#include <cmath>
#include <vector>

extern "C" {

// IC(0) of A + shift*I on the lower-triangle pattern, in place.
// fac[nnz] must enter as a copy of v; exits with strict-lower L values
// at slots [rp[i], lo_cut[i]) (other slots untouched). diag[n] receives
// diag(L). Returns the non-positive-pivot (repaired) count.
long long ic0_pass(const long long* rp, const long long* ci,
                   const double* v, long long n, double shift,
                   double floor_, double* fac, long long* lo_cut,
                   double* diag) {
  std::vector<long long> pos(static_cast<size_t>(n), -1);
  long long breakdowns = 0;
  for (long long i = 0; i < n; ++i) {
    const long long lo = rp[i], hi = rp[i + 1];
    long long cut = lo;
    while (cut < hi && ci[cut] < i) ++cut;
    lo_cut[i] = cut;
    const double a_ii =
        ((cut < hi && ci[cut] == i) ? v[cut] : 0.0) + shift;
    for (long long t = lo; t < cut; ++t) pos[ci[t]] = t;
    for (long long t = lo; t < cut; ++t) {
      const long long k = ci[t];
      double s = 0.0;  // dot over pattern(i) ∩ pattern(k), cols < k
      for (long long u = rp[k]; u < lo_cut[k]; ++u) {
        const long long tu = pos[ci[u]];
        if (tu >= 0) s += fac[tu] * fac[u];
      }
      fac[t] = (fac[t] - s) / diag[k];
    }
    double acc = 0.0;
    for (long long t = lo; t < cut; ++t) acc += fac[t] * fac[t];
    double pivot2 = a_ii - acc;
    if (pivot2 < floor_) {
      breakdowns += (pivot2 <= 0.0);
      const double aa = std::fabs(a_ii);
      pivot2 = aa > floor_ ? aa : floor_;
    }
    diag[i] = std::sqrt(pivot2);
    for (long long t = lo; t < cut; ++t) pos[ci[t]] = -1;
  }
  return breakdowns;
}

}  // extern "C"
