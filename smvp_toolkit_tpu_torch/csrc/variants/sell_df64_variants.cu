// Variants of K8 (csrc/sell_df64.cu, one SpMV), built only by
// smvp_toolkit_tpu_torch/bench/bench_variants.py (--df64), which times
// them against the kept kernel and float64 torch.sparse.mm on the same
// planes in one process; no entry point of the package launches them.
// Each computes K8's function in K8's order, so each is bit-equal to it:
//   0 walk     the row walk K8 ran before: one thread per row, 256 threads
//              (two slices) a block, each thread computing every step's
//              chain itself (sublanes[j], then relsl[s] and tile_base[s /
//              chunk] with a divide, then the x pair), one step after
//              another
//   1 staged   the kept body (df64_group: the slice metadata staged in
//              shared memory) with U steps in flight and S slices a block,
//              U in 1, 2, 4, 8 and S in 1, 2; the kept kernel's are
//              kDf64Unroll and kDf64Slices

#include "../sell_df64.cu"

namespace {

template <typename L>
__device__ __forceinline__ void walk_row(const Df64Args<L>& a, long long t) {
  const long long slice = t >> 7;
  const long long lane = t & (kLanes - 1);
  double acc = 0.0;
  const int end = a.slice_ptr[slice + 1];
  for (int j = a.slice_ptr[slice]; j < end; ++j) {
    const int s = a.sublanes[j];
    const long long rel = static_cast<unsigned>(a.relsl[s]) & kRelDead;
    const long long i = static_cast<long long>(s) * kLanes + lane;
    const long long col =
        (static_cast<long long>(a.tile_base[s / a.chunk]) + rel) * kLanes +
        static_cast<long long>(a.lidx[i]);
    const double vh = a.vals_hi[i];
    const double gh = a.x_hi[col];
    const double gl = a.x_lo[col];
    double e = __dmul_rn(vh, gl);
    if (a.vals_lo != nullptr) {
      const double vl = a.vals_lo[i];
      e = __dadd_rn(e, __dmul_rn(vl, gh));
      e = __dadd_rn(e, __dmul_rn(vl, gl));
    }
    acc = __dadd_rn(acc, __dadd_rn(__dmul_rn(vh, gh), e));
  }
  const float hi = __double2float_rn(acc);
  a.y_hi[t] = hi;
  a.y_lo[t] = __double2float_rn(__dsub_rn(acc, static_cast<double>(hi)));
}

template <typename L>
__global__ void __launch_bounds__(kThreads)
    walk_kernel(const Df64Args<L> a) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t < a.n_rows) walk_row(a, t);
}

template <bool Lo, typename L>
cudaError_t staged(int u, int slices, const Df64Args<L>& a,
                   cudaStream_t st) {
#define STAGED(U, S) \
  if (u == U && slices == S) return launch_df64<U, S, Lo>(a, st);
  STAGED(1, 1)
  STAGED(2, 1)
  STAGED(4, 1)
  STAGED(8, 1)
  STAGED(1, 2)
  STAGED(2, 2)
  STAGED(4, 2)
  STAGED(8, 2)
#undef STAGED
  return cudaErrorInvalidValue;
}

}  // namespace

// Arguments as sell_df64_launch, after the variant id and, for variant 1,
// U and S (ignored by variant 0).
extern "C" int sell_df64_variant_launch(
    int variant, int unroll, int slices, const void* vals_hi,
    const void* vals_lo, const void* lidx, const void* relsl,
    const void* tile_base, const void* slice_ptr, const void* sublanes,
    const void* x_hi, const void* x_lo, void* y_hi, void* y_lo,
    long long n_rows, int chunk, int lidx_kind, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = with_kinds(lidx_kind, vals_lo != nullptr, [&](auto l, auto lo) {
    using L = typename decltype(l)::type;
    const Df64Args<L> a = make_df64_args<L>(
        vals_hi, vals_lo, lidx, relsl, tile_base, slice_ptr, sublanes, x_hi,
        x_lo, y_hi, y_lo, n_rows, chunk, 0);
    if (variant == 1) {
      return staged<decltype(lo)::value>(unroll, slices, a, st);
    }
    if (variant != 0 || n_rows < 1) return cudaErrorInvalidValue;
    const long long blocks = (n_rows + kThreads - 1) / kThreads;
    Df64Args<L> w = a;
    void* params[] = {&w};
    cudaError_t e = cudaLaunchKernel(
        reinterpret_cast<const void*>(walk_kernel<L>),
        dim3(static_cast<unsigned>(blocks)), dim3(kThreads), params, 0, st);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
  });
  return static_cast<int>(err);
}
