// SELL-T1 N-iteration bench kernels for Hopper (sm_90a): N SpMVs in one
// cooperative launch, returning the last y.
//
// Replaces _make_sell_kernel_bench of the JAX package's ops/spmv_pallas.py
// (launched at :2258 for streamed-y plans and :2297 for resident ones), in
// four of its branches:
//   sell_bench_kernel               relsl branch, resident y       (K2)
//   sell_bench_streamy_relsl_kernel relsl branch, streamed y
//   sell_bench_split_kernel         split-plane branch, resident y
//   sell_bench_streamy_kernel       split-plane branch, streamed y
// Each iteration is the forward sweep of csrc/sell_spmv.cu (same body,
// sell_common.cuh). The TPU grid runs in order, so the TPU kernel re-zeroes
// y when an iteration (or, streamed, a y block) starts; on Hopper blocks
// run in no order, so each iteration here zeroes ALL of y in a
// grid-stride loop, grid.sync(), sweeps, grid.sync(). Zeroing all of y
// (not only the visited blocks) keeps a block that no chunk visits at zero.
// The grid is SMs x co-resident blocks (a larger cooperative grid fails at
// launch, not at the sync).
//
// Bound on this card: bytes, as the forward kernels; the planes are
// re-read every iteration, as in the TPU kernel, and at the benchmark
// sizes they exceed the 50 MB L2, so the rate is a memory rate.
//
// C interface (ctypes) as in sell_spmv.cu.

#include <cooperative_groups.h>

#include "sell_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace sell;

template <class Decode, class YAddr, typename V, typename L>
__device__ __forceinline__ void sweeps(const Args<V, L>& a) {
  cg::grid_group grid = cg::this_grid();
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (int it = 0; it < a.iterations; ++it) {
    for (long long i = tid; i < a.n_out; i += stride) a.y[i] = 0.0f;
    grid.sync();
    for (long long i = tid; i < a.n_slots; i += stride) {
      slot<Decode, YAddr>(a, i);
    }
    grid.sync();
  }
}

template <typename V, typename L>
__global__ void __launch_bounds__(kThreads)
    sell_bench_kernel(const Args<V, L> a) {
  sweeps<MergedWord, ResidentY>(a);
}

template <typename V, typename L>
__global__ void __launch_bounds__(kThreads)
    sell_bench_streamy_relsl_kernel(const Args<V, L> a) {
  sweeps<MergedWord, StreamedY>(a);
}

template <typename V, typename L>
__global__ void __launch_bounds__(kThreads)
    sell_bench_streamy_kernel(const Args<V, L> a) {
  sweeps<SplitPlanes, StreamedY>(a);
}

template <typename V, typename L>
__global__ void __launch_bounds__(kThreads)
    sell_bench_split_kernel(const Args<V, L> a) {
  sweeps<SplitPlanes, ResidentY>(a);
}

template <typename V, typename L>
using Kernel = void (*)(Args<V, L>);

template <typename V, typename L>
Kernel<V, L> route_kernel(int route) {
  switch (route) {
    case kRelsl: return sell_bench_kernel<V, L>;
    case kStreamyRelsl: return sell_bench_streamy_relsl_kernel<V, L>;
    case kStreamy: return sell_bench_streamy_kernel<V, L>;
    case kSplit: return sell_bench_split_kernel<V, L>;
    default: return nullptr;
  }
}

template <typename V, typename L>
cudaError_t launch_bench(int route, Args<V, L> a, int device,
                         cudaStream_t stream) {
  const bool split = route == kStreamy || route == kSplit;
  const bool streamed = route == kStreamyRelsl || route == kStreamy;
  if ((split && a.slice == nullptr) ||
      (streamed && (a.y_block_id == nullptr || a.nsb < 1)) ||
      a.iterations < 1) {
    return cudaErrorInvalidValue;
  }
  Kernel<V, L> kernel = route_kernel<V, L>(route);
  int blocks = 0;
  cudaError_t err = cooperative_grid(kernel, device, &blocks);
  if (err != cudaSuccess) return err;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(blocks), dim3(kThreads), params, 0,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Arguments as sell_spmv_launch, plus n_out (the y length, all of which is
// zeroed each iteration) and the iteration count.
extern "C" int sell_bench_launch(int route, const void* vals, const void* lidx,
                                 const void* meta, const void* slice,
                                 const void* tile_base, const void* y_block_id,
                                 const void* x, void* y, long long n_slots,
                                 long long n_out, int chunk, int nsb,
                                 int iterations, int value_kind,
                                 int lidx_kind, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = sell::with_types(value_kind, lidx_kind, [&](auto v, auto l) {
    using V = typename decltype(v)::type;
    using L = typename decltype(l)::type;
    return launch_bench(
        route,
        sell::make_args<V, L>(vals, lidx, meta, slice, tile_base,
                              y_block_id, x, y, n_slots, n_out, chunk, nsb,
                              iterations),
        device, st);
  });
  return static_cast<int>(err);
}

// Blocks of one bench launch of this route on this device (for logs and
// the smoke test).
extern "C" int sell_bench_blocks(int route, int value_kind, int lidx_kind,
                                 int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = sell::with_types(value_kind, lidx_kind, [&](auto v, auto l) {
    using V = typename decltype(v)::type;
    using L = typename decltype(l)::type;
    return cooperative_grid(route_kernel<V, L>(route), device, blocks);
  });
  return static_cast<int>(err);
}
