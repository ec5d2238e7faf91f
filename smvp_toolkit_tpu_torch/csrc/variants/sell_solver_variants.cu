// Variants of K10 and K11 (csrc/sell_solvers.cu, sell_chebyshev_kernel and
// sell_pcg_ic0_kernel), built only by
// smvp_toolkit_tpu_torch/bench/bench_variants.py (--solver), which times
// them against the kept kernels, the plain versions and the scan loops over
// torch.sparse.mm at hpcg104 in one process; no entry point of the package
// launches them. Each is the whole solve (chebyshev_solve, pcg_ic0_solve)
// with its SpMV phases changed:
//   0 walk  the one-thread-per-slot phase both ran before (spmv_range over
//           slot: a 64-bit divide, the metadata loads and a scalar atomic
//           per slot)
//   1 body  the kept phase (SublanePhase: the work items of the phase's
//           slot range on the warp-per-sublane body, plain coherent
//           gathers), built here beside the others
//   2 ldcg  the warp-per-sublane phase gathering through L2 only (__ldcg,
//           ld.global.cg: coherent too, L1 not allocated)
// All three compute the same x up to the summation order of the atomics.

#include "../sell_solvers.cu"

namespace {

struct WalkPhase {
  template <typename V, typename L>
  __device__ __forceinline__ static void run(const Args<V, L>& a,
                                             long long lo, long long hi,
                                             long long tid, long long stride) {
    spmv_range<MergedWord>(a, lo, hi, tid, stride);
  }
};

struct L2Only {
  template <typename T>
  __device__ __forceinline__ static T load(const T* p) {
    return __ldcg(p);
  }
};

struct LdcgPhase {
  template <typename V, typename L>
  __device__ __forceinline__ static void run(const Args<V, L>& a,
                                             long long lo, long long hi,
                                             long long, long long) {
    spmv_items<L2Only>(a, items_before(a, lo), items_before(a, hi));
  }
};

template <class Phase, typename V, typename L>
__global__ void __launch_bounds__(kThreads, kSolverMinBlocks)
    chebyshev_variant_kernel(const SolverArgs<V, L> a) {
  chebyshev_solve<Phase>(a);
}

template <class Phase, typename V, typename L>
__global__ void __launch_bounds__(kThreads, kSolverMinBlocks)
    pcg_ic0_variant_kernel(const SolverArgs<V, L> a) {
  pcg_ic0_solve<Phase>(a);
}

template <class Phase, typename V, typename L>
Kernel<V, L> variant_kernel(int solver) {
  if (solver == kChebyshev) return chebyshev_variant_kernel<Phase, V, L>;
  if (solver == kPcgIc0) return pcg_ic0_variant_kernel<Phase, V, L>;
  return nullptr;
}

template <typename V, typename L>
cudaError_t launch_variant(int solver, int variant, int route,
                           SolverArgs<V, L> a, int device,
                           cudaStream_t stream) {
  Kernel<V, L> kernel = nullptr;
  if (variant == 0) kernel = variant_kernel<WalkPhase, V, L>(solver);
  if (variant == 1) kernel = variant_kernel<SublanePhase, V, L>(solver);
  if (variant == 2) kernel = variant_kernel<LdcgPhase, V, L>(solver);
  if (kernel == nullptr || route != kRelsl || a.iterations < 0 ||
      a.n % kLanes ||
      (solver == kChebyshev && a.iterations > 0 && a.coef == nullptr) ||
      (solver == kPcgIc0 && (a.invd == nullptr || a.z == nullptr ||
                             a.sweeps < 2))) {
    return cudaErrorInvalidValue;
  }
  if (variant != 0) {
    const cudaError_t err = sublane_phase_checks(a);
    if (err != cudaSuccess) return err;
  }
  int blocks = 0;
  cudaError_t err = cooperative_grid(kernel, device, &blocks);
  if (err != cudaSuccess) return err;
  if (solver == kPcgIc0 && blocks > a.part_cap) return cudaErrorInvalidValue;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(blocks), dim3(kThreads), params, 0,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

#define SOLVER_VARIANT_LAUNCH(name, solver)                                   \
  extern "C" int name(                                                        \
      int variant, int route, const void* vals, const void* lidx,             \
      const void* meta, const void* slice, const void* tile_base,             \
      const void* b, const void* coef, const void* invd, void* x, void* r,    \
      void* p, void* q, void* z, void* xin, void* part, long long part_cap,   \
      long long n_slots, long long slots_l0, long long slots_lt0,             \
      long long n, int chunk, int iterations, int sweeps, float inv_theta,    \
      int value_kind, int lidx_kind, int device, void* stream) {              \
    cudaError_t err = cudaSetDevice(device);                                  \
    if (err != cudaSuccess) return static_cast<int>(err);                     \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                      \
    err = with_solver_args(                                                   \
        vals, lidx, meta, slice, tile_base, b, coef, invd, x, r, p, q, z,     \
        xin, part, part_cap, n_slots, slots_l0, slots_lt0, n, chunk,          \
        iterations, sweeps, inv_theta, value_kind, lidx_kind, [&](auto a) {   \
          return launch_variant(solver, variant, route, a, device, st);       \
        });                                                                   \
    return static_cast<int>(err);                                             \
  }

// One Chebyshev (K10) or IC(0)-PCG (K11) solve on a variant (0, 1, 2
// above): arguments as sell_solver_launch, the variant in place of the
// solver id; route 0 (merged word) only.
SOLVER_VARIANT_LAUNCH(sell_chebyshev_variant_launch, kChebyshev)
SOLVER_VARIANT_LAUNCH(sell_pcg_ic0_variant_launch, kPcgIc0)

#undef SOLVER_VARIANT_LAUNCH
