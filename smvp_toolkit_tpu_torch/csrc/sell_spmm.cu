// SELL-T1 fused SpMM kernels for Hopper (sm_90a): Y = A·X for k columns in
// one launch, the planes read once for all k.
//
// Replaces the k > 1 launches of the JAX package's ops/spmv_pallas.py:
//   sell_spmm_kernel       <- _make_sell_kernel_relsl with k > 1 (K1,
//                             launched :1163 resident x, :1191 prefetch x)
//   sell_split_spmm_kernel <- _make_sell_kernel_resident (:1390) and
//                             _make_sell_kernel_prefetch (:1425) with k > 1
//                             (K4)
//   sell_bench_spmm_kernel <- _make_sell_kernel_bench with k > 1, launched
//                             by SellSpMV.bench_loop_mat (:2101, :2135) (K2)
// The TPU kernels widen x and y to k·128 lanes (pack_columns) and split k
// into VMEM-sized launch groups; here X and Y stay row-major (rows, k),
// any k runs in one launch, and no lane layout exists.
//
// Per live slot (s, l) with a nonzero value, for every column j < k:
//   Y[row(s,l), j] += vals[s, l] * X[col(s,l), j]
// (col and row as in sell_common.cuh; resident y only, merged word or
// split planes). A slot whose value is 0 (a padding lane) contributes
// nothing, even against an Inf or NaN in X: the k = 1 kernels land such a
// NaN product, these skip the slot.
//
// Design (sell_common.cuh::warp_slots): one thread per slot decodes its
// slot, so the plane loads are coalesced as in K1. The warp then ballots
// its live nonzero slots and walks them one at a time: the slot's value,
// X row and Y row are broadcast with __shfl_sync, and the 32 lanes cover
// the k columns 32 at a time, so each step reads 32 consecutive X values
// and adds into 32 consecutive Y values (float atomics; compare Y with a
// tolerance, never bitwise). Lanes past k idle when k is not a multiple
// of 32. Every index is 64-bit: X of 169,343 x 256 already passes 2^31 / 64
// rows.
//
// Bound on this card: bytes at small k (the planes, as the k = 1 kernels),
// then X and Y, which grow with k; the arithmetic is 2·nnz·k flops, far
// below the card's rate. The planes are read once per launch whatever k.
//
// The bench kernel runs N such sweeps in one cooperative launch, zeroing
// all of Y between grid.sync()s before each, as the k = 1 bench kernels
// (csrc/sell_bench.cu); merged word only, as the JAX bench_loop_mat.
//
// C interface (ctypes): each launch function returns a cudaError_t value,
// 0 on success, from cudaGetLastError() right after the launch. The
// caller's stream is PyTorch's current stream; nothing here allocates or
// synchronises. The caller zeroes Y before a forward launch.

#include "sell_common.cuh"

namespace {

using namespace sell;

template <typename V, typename L>
__global__ void __launch_bounds__(kThreads)
    sell_spmm_kernel(const MatArgs<V, L> a) {
  mat_sweep<MergedWord>(a);
}

template <typename V, typename L>
__global__ void __launch_bounds__(kThreads)
    sell_split_spmm_kernel(const MatArgs<V, L> a) {
  mat_sweep<SplitPlanes>(a);
}

template <typename V, typename L>
__global__ void __launch_bounds__(kThreads)
    sell_bench_spmm_kernel(const MatArgs<V, L> a) {
  mat_bench_sweeps<MergedWord>(a);
}

template <typename V, typename L>
MatArgs<V, L> make_mat_args(const void* vals, const void* lidx,
                            const void* meta, const void* slice,
                            const void* tile_base, const void* x, void* y,
                            long long n_slots, long long n_out, int chunk,
                            int k, int iterations) {
  return MatArgs<V, L>{static_cast<const V*>(vals),
                       static_cast<const L*>(lidx),
                       static_cast<const int*>(meta),
                       static_cast<const int*>(slice),
                       static_cast<const int*>(tile_base),
                       static_cast<const V*>(x),
                       nullptr,
                       static_cast<float*>(y),
                       n_slots,
                       n_out,
                       chunk,
                       k,
                       iterations};
}

template <typename V, typename L>
cudaError_t launch_spmm(int route, MatArgs<V, L> a, cudaStream_t stream) {
  void (*kernel)(MatArgs<V, L>) = nullptr;
  if (route == kRelsl) kernel = sell_spmm_kernel<V, L>;
  if (route == kSplit && a.slice != nullptr) {
    kernel = sell_split_spmm_kernel<V, L>;
  }
  const long long blocks = (a.n_slots + kThreads - 1) / kThreads;
  if (kernel == nullptr || a.k < 1 || blocks < 1 || blocks > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  void* params[] = {&a};
  cudaError_t err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel),
                                     dim3(static_cast<unsigned>(blocks)),
                                     dim3(kThreads), params, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename V, typename L>
cudaError_t launch_bench_spmm(MatArgs<V, L> a, int device,
                              cudaStream_t stream) {
  if (a.k < 1 || a.iterations < 1) return cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err =
      cooperative_grid(sell_bench_spmm_kernel<V, L>, device, &blocks);
  if (err != cudaSuccess) return err;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(sell_bench_spmm_kernel<V, L>),
      dim3(blocks), dim3(kThreads), params, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// route: sell::kRelsl (merged word; slice null) or sell::kSplit.
// value_kind: 0 = float32, 1 = bfloat16 (vals and X). lidx_kind: 0 = int8,
// 1 = int32. X has k columns, Y is (n_slices * 128, k) float32, zeroed.
extern "C" int sell_spmm_launch(int route, const void* vals, const void* lidx,
                                const void* meta, const void* slice,
                                const void* tile_base, const void* x, void* y,
                                long long n_slots, int chunk, int k,
                                int value_kind, int lidx_kind, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = sell::with_types(value_kind, lidx_kind, [&](auto v, auto l) {
    using V = typename decltype(v)::type;
    using L = typename decltype(l)::type;
    return launch_spmm(route,
                       make_mat_args<V, L>(vals, lidx, meta, slice, tile_base,
                                           x, y, n_slots, 0, chunk, k, 0),
                       st);
  });
  return static_cast<int>(err);
}

// The merged-word N-iteration kernel; n_out = n_slices * 128 * k, all of
// which is zeroed each iteration.
extern "C" int sell_bench_spmm_launch(const void* vals, const void* lidx,
                                      const void* relsl, const void* tile_base,
                                      const void* x, void* y,
                                      long long n_slots, long long n_out,
                                      int chunk, int k, int iterations,
                                      int value_kind, int lidx_kind,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = sell::with_types(value_kind, lidx_kind, [&](auto v, auto l) {
    using V = typename decltype(v)::type;
    using L = typename decltype(l)::type;
    return launch_bench_spmm(
        make_mat_args<V, L>(vals, lidx, relsl, nullptr, tile_base, x, y,
                            n_slots, n_out, chunk, k, iterations),
        device, st);
  });
  return static_cast<int>(err);
}

// Blocks of one sell_bench_spmm_kernel launch on this device.
extern "C" int sell_bench_spmm_blocks(int value_kind, int lidx_kind,
                                      int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = sell::with_types(value_kind, lidx_kind, [&](auto v, auto l) {
    using V = typename decltype(v)::type;
    using L = typename decltype(l)::type;
    return cooperative_grid(sell_bench_spmm_kernel<V, L>, device, blocks);
  });
  return static_cast<int>(err);
}
