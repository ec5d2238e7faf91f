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
// Each iteration computes the forward sweep of csrc/sell_spmv.cu in its
// body, the warp per sublane (sell_common.cuh, sublane_bench_sweeps under
// the route's staging and y policy: the (chunk, run) work items of K1,
// K3-relsl, K3-split and K4, walked in a grid-stride loop), built under
// __launch_bounds__(kThreads, kSublaneMinBlocks). The TPU grid runs in
// order, so the TPU kernel re-zeroes y when an iteration (or, streamed, a y
// block) starts; on Hopper blocks run in no order, so every iteration here
// zeroes ALL of a y buffer behind a grid barrier (not only the visited
// blocks, so that a block that no chunk visits stays zero). K2 takes two
// y buffers in turn, one grid.sync() an iteration: it sweeps into y[it %
// 2] while it zeroes y[(it + 1) % 2]. The other three zero their one y
// between two grid.sync()s. Timed on the H100 against each other
// (smvp_toolkit_tpu_torch/bench/bench_variants.py), the one barrier won
// on K2 in both value types (2.8-5.3% at smoke, 15-20% on a smoke-dp4
// shard) and lost somewhere on each of the other three (L1 f32, L2 bf16,
// L3 f32). The caller passes bench_y_buffers(route) * n_out floats and
// reads the result in buffer (N - 1) % bench_y_buffers(route).
// The grid is SMs x co-resident blocks (a larger cooperative grid fails at
// launch, not at the sync); the occupancy query that sizes it sees each
// kernel's registers and static shared memory, and the launch bound
// (kSublaneMinBlocks) holds it at eight blocks an SM: 1,056 on an H100.
// The grid-stride walk is static: smoke's 2,944 work items are 2.79 per
// block, so some blocks take three and some two.
//
// Bound on this card: bytes, as the forward kernels; the planes are
// re-read every iteration, as in the TPU kernel, and at the benchmark
// sizes they exceed the 50 MB L2, so the rate is a memory rate: N times
// the planes' bytes over the memory rate is the least time. On top of the
// forward sweep an iteration pays one buffer's zeroing (smoke 4.0 MB, L1
// 16.8 MB), one or two grid.sync()s and the walk's static tail.
//
// K2-subwin (sell_bench_subwin_kernel) is the relsl branch with
// per-sub-chain windows (SMVP_SELL_SUBWIN=1; _sub_windows :223 through
// _relsl_chain_store's subwin branch :329-357, launched :2297). Each chunk
// is cut into `split` sub-chains of chunk/split sublanes; sub-chain h of
// chunk c reads x from its own window of sub_wt tiles at stb[c, h] and
// reduces into its own window of sub_nsw slices at ssb[c, h]. Per slot:
//   rel_adj = rel - (stb[c, h] - tile_base[c])
//   y[slice·128 + l] += vals · x[(stb[c, h] + rel_adj)·128 + lidx]
// only when 0 <= rel_adj < sub_wt and ssb[c, h] <= slice < ssb[c, h] +
// sub_nsw; any other slot (dead sublanes included: rel 511 and the dead
// slice id fall outside every window) contributes nothing, as the TPU's
// windowed one-hot products drop it. Every quantity of that rule (h, the
// window bases, the test, the column) is the same for a whole sublane, and
// the column equals K2's, so K2-subwin is K2's function with more sublanes
// marked dead: it runs K2's body (sublane_bench_sweeps) under its own
// staging policy, SubwinWord, which applies the rule once per sublane and
// stages K2's rel and slice or -1. Only the window rule lets a wrong stb or
// ssb show in y. It takes two y buffers and one barrier an iteration, as
// K2 does (kSubwinYBuffers; one buffer and two barriers is a variant in
// csrc/variants/sell_bench_variants.cu, timed against it by
// bench/bench_variants.py), under the same launch bounds and checks.
// Before, it ran one thread per slot, paying per slot a 64-bit divide for
// h, the window loads and the word's decoding, and a scalar atomic: 32.4 ms
// at smoke, N = 200, against K2's 10.5 ms (NVIDIA H100 80GB HBM3, 700 W,
// chip_smoke.py).
//
// C interface (ctypes) as in sell_spmv.cu: on all four routes a plane not
// aligned for the vector loads returns cudaErrorMisalignedAddress, and
// planes that are not whole chunks (or hold no sublane)
// cudaErrorInvalidValue; neither launches anything.

#include "sell_common.cuh"

namespace {

using namespace sell;

// y buffers of each route's N-iteration kernel (ops/spmv_sell.py,
// BENCH_Y_BUFFERS, allocates them).
__host__ __device__ constexpr int bench_y_buffers(int route) {
  return route == kRelsl ? 2 : 1;
}

template <typename V, typename L>
__global__ void __launch_bounds__(kThreads, kSublaneMinBlocks)
    sell_bench_kernel(const Args<V, L> a) {
  sublane_bench_sweeps<MergedWord, ResidentY, bench_y_buffers(kRelsl)>(a);
}

template <typename V, typename L>
__global__ void __launch_bounds__(kThreads, kSublaneMinBlocks)
    sell_bench_streamy_relsl_kernel(const Args<V, L> a) {
  sublane_bench_sweeps<MergedWord, StreamedY,
                       bench_y_buffers(kStreamyRelsl)>(a);
}

template <typename V, typename L>
__global__ void __launch_bounds__(kThreads, kSublaneMinBlocks)
    sell_bench_streamy_kernel(const Args<V, L> a) {
  sublane_bench_sweeps<SplitPlanes, StreamedY, bench_y_buffers(kStreamy)>(a);
}

template <typename V, typename L>
__global__ void __launch_bounds__(kThreads, kSublaneMinBlocks)
    sell_bench_split_kernel(const Args<V, L> a) {
  sublane_bench_sweeps<SplitPlanes, ResidentY, bench_y_buffers(kSplit)>(a);
}

// y buffers of K2-subwin (ops/spmv_sell.py, SUBWIN_Y_BUFFERS, allocates
// them; the result is buffer (N - 1) % kSubwinYBuffers).
constexpr int kSubwinYBuffers = 2;

template <typename V, typename L>
__global__ void __launch_bounds__(kThreads, kSublaneMinBlocks)
    sell_bench_subwin_kernel(const SubwinArgs<V, L> a) {
  sublane_bench_sweeps<SubwinWord, ResidentY, kSubwinYBuffers>(a);
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
  if (!sublane_aligned(a)) return cudaErrorMisalignedAddress;
  long long items = 0;
  if (!sublane_items(a, &items) || a.n_out % 4) return cudaErrorInvalidValue;
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

// Arguments as sell_spmv_launch, plus n_out (the length of one y buffer)
// and the iteration count; y holds bench_y_buffers(route) buffers of n_out
// floats, and the result is buffer (iterations - 1) % bench_y_buffers(route).
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

// K2-subwin: arguments as sell_bench_launch on the relsl route, plus the
// (n_chunks, split) int32 window bases stb and ssb and the window sizes;
// y holds kSubwinYBuffers buffers of n_out floats, and the result is
// buffer (iterations - 1) % kSubwinYBuffers. Misaligned planes return
// cudaErrorMisalignedAddress, planes that are not whole chunks (or hold
// no sublane) cudaErrorInvalidValue, as sell_bench_launch.
extern "C" int sell_bench_subwin_launch(
    const void* vals, const void* lidx, const void* relsl,
    const void* tile_base, const void* stb, const void* ssb, const void* x,
    void* y, long long n_slots, long long n_out, int chunk, int split,
    int sub_wt, int sub_nsw, int iterations, int value_kind, int lidx_kind,
    int device, void* stream) {
  if (split < 2 || chunk % split || sub_wt < 1 || sub_nsw < 1 ||
      iterations < 1 || stb == nullptr || ssb == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = sell::with_types(value_kind, lidx_kind, [&](auto v, auto l) {
    using V = typename decltype(v)::type;
    using L = typename decltype(l)::type;
    SubwinArgs<V, L> a{
        sell::make_args<V, L>(vals, lidx, relsl, nullptr, tile_base,
                              nullptr, x, y, n_slots, n_out, chunk, 0,
                              iterations),
        static_cast<const int*>(stb), static_cast<const int*>(ssb), split,
        sub_wt, sub_nsw};
    if (!sublane_aligned(a)) return cudaErrorMisalignedAddress;
    long long items = 0;
    if (!sublane_items(a, &items) || n_out % 4) return cudaErrorInvalidValue;
    auto kernel = sell_bench_subwin_kernel<V, L>;
    int blocks = 0;
    cudaError_t e = cooperative_grid(kernel, device, &blocks);
    if (e != cudaSuccess) return e;
    void* params[] = {&a};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(blocks), dim3(kThreads), params, 0,
                                    st);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
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
