// The ILU(0) and IC(0) factorization passes of ops/ilu.py, in host C++.
//
// Copies of the JAX package's native/ilu.cpp ilu0_pass and ic0_pass, with
// the same C signatures. Each mirrors its numpy pass (ops/ilu.py:_ilu0_pass,
// _ic0_pass) operation for operation (same elimination order, same
// sequential accumulation), so the two produce bit-identical arrays;
// ops/_build.py compiles it with the host compiler and -ffp-contract=off,
// so no multiply-add is fused into one rounding. The Python callers
// (ops/ilu.py:ilu0, ic0) keep the Manteuffel shift ladder and the
// acceptance test; only the elimination lives here, the part whose
// interpreted loop would dominate a factorization at the HPCG 104³ size.
//
// Sparse row lookups use a marker array: pos[col] holds the in-row slot
// while a row is active (-1 otherwise) and only touched entries are reset,
// so a pass is O(sum_i row_i · coupled-row length) with O(1) lookups.

#include <cmath>
#include <vector>

extern "C" {

// ILU(0) IKJ elimination of A + shift*I, in place on A's CSR pattern.
// fac[nnz] must enter as a copy of v; exits holding L (cols<row) and
// strict-U (cols>row) factor values. u_diag[n] receives the pivots
// (shift applied, floored). Returns the floored-pivot count.
long long ilu0_pass(const long long* rp, const long long* ci,
                    long long n, double shift, double floor_,
                    double* fac, double* u_diag) {
  std::vector<long long> pos(static_cast<size_t>(n), -1);
  std::vector<long long> ustart(static_cast<size_t>(n));
  long long fixed = 0;
  for (long long i = 0; i < n; ++i) {
    const long long lo = rp[i], hi = rp[i + 1];
    for (long long t = lo; t < hi; ++t) pos[ci[t]] = t;
    for (long long t = lo; t < hi; ++t) {
      const long long k = ci[t];
      if (k >= i) break;
      const double w = fac[t] / u_diag[k];
      fac[t] = w;
      for (long long s = ustart[k]; s < rp[k + 1]; ++s) {
        const long long tj = pos[ci[s]];
        if (tj >= 0) fac[tj] -= w * fac[s];
      }
    }
    // The diagonal slot (first col >= i) splits L | diag | U.
    long long split = lo;
    while (split < hi && ci[split] < i) ++split;
    double piv;
    if (split < hi && ci[split] == i) {
      piv = fac[split] + shift;
      ustart[i] = split + 1;
    } else {
      piv = shift;
      ustart[i] = split;
    }
    if (std::fabs(piv) < floor_) {
      piv = piv >= 0 ? floor_ : -floor_;
      ++fixed;
    }
    u_diag[i] = piv;
    for (long long t = lo; t < hi; ++t) pos[ci[t]] = -1;
  }
  return fixed;
}

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
