// SELL-T1 SpMV forward kernels for Hopper (sm_90a): y = A·x in one launch.
//
// Replaces the single-SpMV Pallas TPU kernels of the JAX package's
// ops/spmv_pallas.py (k = 1):
//   K1       sell_spmv_kernel          <- _make_sell_kernel_relsl (+ _relsl_chain_store)
//   K3-relsl sell_streamy_relsl_kernel <- _make_sell_kernel_streamy_relsl
//   K3-split sell_streamy_kernel       <- _make_sell_kernel_streamy
//   K4       sell_split_kernel         <- _make_sell_kernel_resident,
//                                         _make_sell_kernel_prefetch,
//                                         _make_sell_kernel
// All four are one body (sell_common.cuh, forward_sweep) under the two
// route policies:
// merged word or split planes, resident or block-streamed y. The TPU's
// resident-x / scalar-prefetch / window-stack split is about VMEM and has
// no meaning here: one kernel serves all three. So does the TPU's one-hot
// MXU table select and row reduce, which exist because the TPU has no fast
// gather or scatter; Hopper has both (see sell_common.cuh).
//
// Streamed y: the caller zeroes all of y (n_slices * 128 floats) before
// the launch, so a y block that no chunk visits comes back zero.
//
// Bound on this card: bytes. One launch must read the vals and lane-index
// planes (S * 128 * (value + index bytes), padding slots included), the
// route's per-sublane metadata (one merged int32 word, or two split
// words), tile_base (and y_block_id when streamed), x once, and write y
// once (SellPlan.traffic_bytes). The arithmetic, 2 flops per nonzero, is
// far below the card's rate. The design reads each plane byte once per
// launch and skips the atomic for zero products, which are most of the
// slots at the planes' occupancy.
//
// C interface (ctypes): sell_spmv_launch returns a cudaError_t value, 0 on
// success, from cudaGetLastError() right after the launch. Pointers and
// the stream come in as void*, sizes as long long. The caller's stream is
// PyTorch's current stream; nothing here allocates or synchronises.

#include "sell_common.cuh"

namespace {

using namespace sell;

template <typename V, typename L>
__global__ void __launch_bounds__(kThreads)
    sell_spmv_kernel(const Args<V, L> a) {
  forward_sweep<MergedWord, ResidentY>(a);
}

template <typename V, typename L>
__global__ void __launch_bounds__(kThreads)
    sell_streamy_relsl_kernel(const Args<V, L> a) {
  forward_sweep<MergedWord, StreamedY>(a);
}

template <typename V, typename L>
__global__ void __launch_bounds__(kThreads)
    sell_streamy_kernel(const Args<V, L> a) {
  forward_sweep<SplitPlanes, StreamedY>(a);
}

template <typename V, typename L>
__global__ void __launch_bounds__(kThreads)
    sell_split_kernel(const Args<V, L> a) {
  forward_sweep<SplitPlanes, ResidentY>(a);
}

template <typename V, typename L>
cudaError_t launch(void (*kernel)(Args<V, L>), Args<V, L> a,
                   cudaStream_t stream) {
  const long long blocks = (a.n_slots + kThreads - 1) / kThreads;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  void* params[] = {&a};
  cudaError_t err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel),
                                     dim3(static_cast<unsigned>(blocks)),
                                     dim3(kThreads), params, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename V, typename L>
cudaError_t launch_route(int route, const Args<V, L>& a, cudaStream_t st) {
  const bool split = route == kStreamy || route == kSplit;
  const bool streamed = route == kStreamyRelsl || route == kStreamy;
  if ((split && a.slice == nullptr) ||
      (streamed && (a.y_block_id == nullptr || a.nsb < 1))) {
    return cudaErrorInvalidValue;
  }
  switch (route) {
    case kRelsl: return launch(sell_spmv_kernel<V, L>, a, st);
    case kStreamyRelsl: return launch(sell_streamy_relsl_kernel<V, L>, a, st);
    case kStreamy: return launch(sell_streamy_kernel<V, L>, a, st);
    case kSplit: return launch(sell_split_kernel<V, L>, a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// route: sell::Route. value_kind: 0 = float32, 1 = bfloat16. lidx_kind:
// 0 = int8, 1 = int32. slice is null on merged routes, y_block_id on
// resident ones.
extern "C" int sell_spmv_launch(int route, const void* vals, const void* lidx,
                                const void* meta, const void* slice,
                                const void* tile_base, const void* y_block_id,
                                const void* x, void* y, long long n_slots,
                                int chunk, int nsb, int value_kind,
                                int lidx_kind, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = sell::with_types(value_kind, lidx_kind, [&](auto v, auto l) {
    using V = typename decltype(v)::type;
    using L = typename decltype(l)::type;
    return launch_route(
        route,
        sell::make_args<V, L>(vals, lidx, meta, slice, tile_base,
                              y_block_id, x, y, n_slots, 0, chunk, nsb, 0),
        st);
  });
  return static_cast<int>(err);
}
