// Variants of the k-column body of csrc/sell_spmm.cu (K1 and K4 with k
// columns, and K2 with k columns' forms below), built only by
// smvp_toolkit_tpu_torch/bench/bench_variants.py (--kcol, --kbench), which
// times them against the kept kernels on the same planes in one process;
// no entry point of the package launches them. Each runs the
// merged word (sell::kRelsl) or the split planes (sell::kSplit), int8 lane
// indices, four-element columns (k % 4 == 0), with one thing changed:
//   0 shape     the kept body at a given column shape (T threads a row, P
//               passes: T * 4 * P columns a column block) and run cap (the
//               sublanes a unit sums at most: 4, 8, 16 or 64)
//   1 nosum     the body without run-summing (a cap of 1): every sublane
//               flushes its own rows, one vector atomic per nonzero slot
//   2 slots     the one-thread-per-slot warp walk that K1 and K4 with k
//               columns ran before (sell_common.cuh, warp_slots: a warp per
//               32 slots, float atomics over k)
//   3 blocks8   the kept body under __launch_bounds__(256, 8): eight
//               co-resident blocks on an SM, 32 registers a thread
// Variants 0, 1 and 3 take every shape that `shaped` lists; variant 2
// ignores shape and cap.
//
// K2 with k columns (sell_bench_spmm_kernel) in one of its forms
// (sell_bench_spmm_variant_launch, merged word, int8 lane indices, any k,
// the column shape of with_mat_shape):
//   0 walk      the one-thread-per-slot warp walk it ran before
//               (mat_bench_sweeps over warp_slots: all of Y zeroed with
//               scalar stores, grid.sync(), the sweep, grid.sync())
//   1 buffers1  the k-column body (sublane_mat_bench_sweeps), one Y
//               buffer, two grid.sync()s an iteration
//   2 buffers2  the same body, two Y buffers, one grid.sync() an iteration
// Forms 0 and 1 leave the result in Y[0], form 2 in Y[(N - 1) % 2].

#include "../sell_spmm.cu"

namespace {

using namespace sell;

template <typename V>
using MKernel = void (*)(MatArgs<V, int8_t>);

template <int Variant, int Cap, class Stage, int T, int P, typename V>
__global__ void __launch_bounds__(kThreads,
                                  Variant == 3 ? 8 : kMatMinBlocks)
    spmm_variant_kernel(const MatArgs<V, int8_t> a) {
  sublane_mat_sweep<Stage, MatShape<T, 4, P>, Cap>(a);
}

template <class Decode, typename V>
__global__ void __launch_bounds__(kThreads)
    spmm_slots_kernel(const MatArgs<V, int8_t> a) {
  mat_sweep<Decode>(a);
}

// The (T, P) shapes a variant takes at run cap Cap; nullptr for any other.
template <int Variant, int Cap, class Stage, typename V>
MKernel<V> shaped(int t, int p) {
#define SHAPE(T_, P_)       \
  if (t == T_ && p == P_) { \
    return spmm_variant_kernel<Variant, Cap, Stage, T_, P_, V>; \
  }
  SHAPE(1, 1)
  SHAPE(1, 2)
  SHAPE(1, 4)
  SHAPE(2, 1)
  SHAPE(2, 4)
  SHAPE(2, 5)
  SHAPE(4, 3)
  SHAPE(4, 4)
  SHAPE(8, 2)
  SHAPE(8, 4)
  SHAPE(16, 1)
  SHAPE(16, 4)
  SHAPE(32, 2)
#undef SHAPE
  return nullptr;
}

template <class Stage, typename V>
MKernel<V> variant_of(int variant, int t, int p, int cap) {
  if (variant == 1) return shaped<1, 1, Stage, V>(t, p);
  if (variant == 3) return shaped<3, kMatRunCap, Stage, V>(t, p);
  if (variant != 0) return nullptr;
  switch (cap) {
    case 4: return shaped<0, 4, Stage, V>(t, p);
    case 8: return shaped<0, 8, Stage, V>(t, p);
    case 16: return shaped<0, 16, Stage, V>(t, p);
    case 64: return shaped<0, 64, Stage, V>(t, p);
    default: return nullptr;
  }
}

// The k-column N-iteration body K2 with k columns ran before (form 0): one
// cooperative launch, zeroing all of Y between grid.sync()s before each
// one-thread-per-slot sweep.
template <class Decode, typename V, typename L>
__device__ __forceinline__ void mat_bench_sweeps(const MatArgs<V, L>& a) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (int it = 0; it < a.iterations; ++it) {
    for (long long i = tid; i < a.n_out; i += stride) a.out[i] = 0.0f;
    grid.sync();
    // stride is a multiple of 32, so the lanes of a warp agree on the loop.
    for (long long i = tid; (i & ~31LL) < a.n_slots; i += stride) {
      warp_slots<Decode>(a, i);
    }
    grid.sync();
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
    bench_spmm_walk_kernel(const MatArgs<V, int8_t> a) {
  mat_bench_sweeps<MergedWord>(a);
}

template <int YBuffers, int T, int W, int P, typename V>
__global__ void __launch_bounds__(kThreads, kMatMinBlocks)
    bench_spmm_form_kernel(const MatArgs<V, int8_t> a) {
  sublane_mat_bench_sweeps<MergedWord, MatShape<T, W, P>, YBuffers>(a);
}

template <typename V>
cudaError_t launch_bench_form(int form, MatArgs<V, int8_t> a, int device,
                              cudaStream_t stream) {
  if (form < 0 || form > 2 || a.iterations < 1 || a.n_out % 4) {
    return cudaErrorInvalidValue;
  }
  return with_mat_shape(a.k, [&](auto shape) {
    using Sh = decltype(shape);
    long long items = 0, col_blocks = 0;
    cudaError_t err = mat_work<Sh>(a, &items, &col_blocks);
    if (err != cudaSuccess) return err;
    if (items * col_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(a.out) % 16) {
      return cudaErrorMisalignedAddress;
    }
    const MKernel<V> kernel =
        form == 0   ? bench_spmm_walk_kernel<V>
        : form == 1 ? bench_spmm_form_kernel<1, Sh::kT, Sh::kW, Sh::kP, V>
                    : bench_spmm_form_kernel<2, Sh::kT, Sh::kW, Sh::kP, V>;
    int blocks = 0;
    err = cooperative_grid(kernel, device, &blocks);
    if (err != cudaSuccess) return err;
    void* params[] = {&a};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                      dim3(blocks), dim3(kThreads), params,
                                      0, stream);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  });
}

template <typename V>
cudaError_t launch_variant(int variant, int route, int t, int p, int cap,
                           MatArgs<V, int8_t> a, cudaStream_t stream) {
  const bool split = route == kSplit;
  if ((route != kRelsl && !split) || (split && a.slice == nullptr) ||
      a.k < 1 || a.k % 4 || (variant != 2 && (t < 1 || p < 1))) {
    return cudaErrorInvalidValue;
  }
  void* params[] = {&a};
  if (variant == 2) {
    const long long blocks = (a.n_slots + kThreads - 1) / kThreads;
    if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    const MKernel<V> kernel = split ? spmm_slots_kernel<SplitPlanes, V>
                                    : spmm_slots_kernel<MergedWord, V>;
    cudaError_t err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel),
                                       dim3(static_cast<unsigned>(blocks)),
                                       dim3(kThreads), params, 0, stream);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  }
  const MKernel<V> kernel =
      split ? variant_of<SplitPlanes, V>(variant, t, p, cap)
            : variant_of<MergedWord, V>(variant, t, p, cap);
  if (kernel == nullptr) return cudaErrorInvalidValue;
  const int cols = t * 4 * p;
  long long items = 0;
  if (!sublane_items(a, &items)) return cudaErrorInvalidValue;
  const auto at = [](const void* q, size_t n) {
    return reinterpret_cast<uintptr_t>(q) % n == 0;
  };
  if (!at(a.vals, 4 * sizeof(V)) || !at(a.x, 4 * sizeof(V)) ||
      !at(a.out, 16)) {
    return cudaErrorMisalignedAddress;
  }
  cudaError_t err = cudaLaunchKernel(
      reinterpret_cast<const void*>(kernel),
      dim3(static_cast<unsigned>(items),
           static_cast<unsigned>((a.k + cols - 1) / cols)),
      dim3(kThreads), params, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Arguments as sell_spmm_launch (int8 lane indices only, k % 4 == 0), plus
// the variant, the column shape (t threads a row, p passes) and the run cap
// (variant 0); Y is (n_slices * 128, k) float32, zeroed by the caller.
extern "C" int sell_spmm_variant_launch(
    int variant, int route, int t, int p, int cap, const void* vals,
    const void* lidx,
    const void* meta, const void* slice, const void* tile_base, const void* x,
    void* y, long long n_slots, int chunk, int k, int value_kind, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto tag) {
    using V = typename decltype(tag)::type;
    sell::MatArgs<V, int8_t> a{static_cast<const V*>(vals),
                               static_cast<const int8_t*>(lidx),
                               static_cast<const int*>(meta),
                               static_cast<const int*>(slice),
                               static_cast<const int*>(tile_base),
                               static_cast<const V*>(x),
                               nullptr,
                               static_cast<float*>(y),
                               n_slots,
                               0,
                               chunk,
                               k,
                               0};
    return launch_variant<V>(variant, route, t, p, cap, a, st);
  };
  if (value_kind == 0) err = go(sell::Tag<float>{});
  else if (value_kind == 1) err = go(sell::Tag<__nv_bfloat16>{});
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// K2 with k columns in one of its forms (0, 1, 2 above): arguments as
// sell_bench_spmm_launch (int8 lane indices only), after the form; y holds
// 2 * n_out floats.
extern "C" int sell_bench_spmm_variant_launch(
    int form, const void* vals, const void* lidx, const void* relsl,
    const void* tile_base, const void* x, void* y, long long n_slots,
    long long n_out, int chunk, int k, int iterations, int value_kind,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto tag) {
    using V = typename decltype(tag)::type;
    return launch_bench_form<V>(
        form,
        make_mat_args<V, int8_t>(vals, lidx, relsl, nullptr, tile_base, x, y,
                                 n_slots, n_out, chunk, k, iterations),
        device, st);
  };
  if (value_kind == 0) err = go(sell::Tag<float>{});
  else if (value_kind == 1) err = go(sell::Tag<__nv_bfloat16>{});
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
