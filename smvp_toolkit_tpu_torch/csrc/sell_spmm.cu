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
// Design. K1 and K4 with k columns run the warp-per-sublane k-column body
// (sell_common.cuh, sublane_mat_run; the merged word and the split planes):
// a block per work item (64 sublanes of one chunk) and column block, the
// item's rel and slice staged in shared memory, dead sublanes skipped
// before any plane load, each live sublane's nonzero lanes found with one
// vector load of values a thread and four ballots. A run of sublanes of
// one slice (the planner's duplicate sublanes of a row's tile lie next to
// each other) is summed per row in registers and each row it touches gets
// one vector atomic, not one a sublane: on gcn_arxiv that cuts Y's row
// updates from nnz (1,448,814) to about 0.5M a launch; a unit sums at most
// 16 sublanes (kMatRunCap), so a hub row's runs of up to 129 sublanes are
// several units side by side. T threads take a row's k columns, P loads
// each (the column shape, with_mat_shape below, picked from k at launch):
// X is gathered and Y updated four columns a load (a float4 in f32, four
// bf16 in 8 bytes; red.global.add.v4.f32) where k % 4 == 0, else one
// column a load in the same body. X, Y, the values
// plane and whole chunks are checked at launch: a view not aligned for the
// form returns cudaErrorMisalignedAddress, planes of no sublane
// cudaErrorInvalidValue, and nothing launches. Sums are float32 in an order
// that changes from run to run: compare Y with a tolerance, never bitwise.
// Every index into X and Y is 64-bit: X of 169,343 x 256 already passes
// 2^31 / 64 rows.
//
// The N-iteration kernel (sell_bench_spmm_kernel, K2 with k > 1) runs the
// same body N times in one cooperative launch (sell_common.cuh,
// sublane_mat_bench_sweeps): each iteration walks the items x column
// blocks pieces of work in a block-uniform grid-stride loop over a grid of
// co-resident blocks, column block by column block, and Y takes
// kBenchMatYBuffers buffers (below). Before, it ran the one-thread-per-slot
// warp walk (warp_slots: one thread decoding each slot, the warp walking
// its live slots one at a time, a scalar atomic per product and column,
// all of Y zeroed with scalar stores between two grid.sync()s): 186.4 ms
// at smoke, k = 8, N = 200 (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py);
// that walk is a variant now (csrc/variants/sell_spmm_variants.cu). The
// packed k-column kernel (csrc/sell_packed.cu: its word carries rel per
// slot) and the values gradient (csrc/sell_vals_grad.cu: another
// reduction) keep their own bodies.
//
// Bound on this card: bytes at small k (the planes, as the k = 1 kernels),
// then X and Y, which grow with k; the arithmetic is 2·nnz·k flops, far
// below the card's rate. The planes are read once per launch and column
// block (k <= 256 in f32 and bf16 is one column block). At k = 256 the
// gathers read nnz · k · 4 bytes of X rows, 8.6x X itself on gcn_arxiv:
// whether they come from L2 decides the time.
//
// The bench kernel runs N sweeps of the k-column body in one cooperative
// launch; merged word only, as the JAX bench_loop_mat. It takes the forward
// kernels' checks (column shape's alignment, whole chunks, the column-block
// limit) and Y aligned to 16 bytes for its float4 zeroing.
//
// C interface (ctypes): each launch function returns a cudaError_t value,
// 0 on success, from cudaGetLastError() right after the launch. The
// caller's stream is PyTorch's current stream; nothing here allocates or
// synchronises. The caller zeroes Y before a forward launch.

#include "sell_common.cuh"

namespace {

using namespace sell;

template <typename V, typename L>
using MatKernel = void (*)(MatArgs<V, L>);

template <int T, int W, int P, typename V, typename L>
__global__ void __launch_bounds__(kThreads, kMatMinBlocks)
    sell_spmm_kernel(const MatArgs<V, L> a) {
  sublane_mat_sweep<MergedWord, MatShape<T, W, P>>(a);
}

template <int T, int W, int P, typename V, typename L>
__global__ void __launch_bounds__(kThreads, kMatMinBlocks)
    sell_split_spmm_kernel(const MatArgs<V, L> a) {
  sublane_mat_sweep<SplitPlanes, MatShape<T, W, P>>(a);
}

// Y buffers of the N-iteration kernel: two, taken in turn, one grid.sync()
// an iteration, the result in Y[(N - 1) % 2] (ops/spmv_sell.py,
// MAT_BENCH_Y_BUFFERS, mirrors it). The form with one buffer and two
// barriers is a variant (csrc/variants/sell_spmm_variants.cu).
constexpr int kBenchMatYBuffers = 2;

template <int T, int W, int P, typename V, typename L>
__global__ void __launch_bounds__(kThreads, kMatMinBlocks)
    sell_bench_spmm_kernel(const MatArgs<V, L> a) {
  sublane_mat_bench_sweeps<MergedWord, MatShape<T, W, P>, kBenchMatYBuffers>(
      a);
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

// Calls fn(MatShape<T, W, P>{}) for k columns: four-element columns (W = 4)
// where k % 4 == 0, else one (W = 1). A thread takes up to four loads of a
// row (P), and T is the least power of two whose threads then cover it, at
// most 8 (vector) or 32 (scalar): past that, more column blocks. Few
// threads a row and several loads a thread keep more units and gathers in
// flight per warp. At k = 8 in f32 one thread takes a row (two float4), at
// k = 40 four threads, at k = 256 eight threads in two column blocks of
// 128 (measured against other shapes: bench/bench_variants.py --kcol).
// ops/spmv_sell.py (spmm_shape) mirrors this table.
template <typename Fn>
cudaError_t with_mat_shape(int k, Fn&& fn) {
  if (k < 1) return cudaErrorInvalidValue;
  if (k % 4 == 0) {
    const int n4 = k / 4;
    if (n4 <= 1) return fn(MatShape<1, 4, 1>{});
    if (n4 <= 2) return fn(MatShape<1, 4, 2>{});
    if (n4 <= 4) return fn(MatShape<1, 4, 4>{});
    if (n4 <= 8) return fn(MatShape<2, 4, 4>{});
    if (n4 <= 16) return fn(MatShape<4, 4, 4>{});
    return fn(MatShape<8, 4, 4>{});
  }
  if (k <= 4) return fn(MatShape<1, 1, 4>{});
  if (k <= 8) return fn(MatShape<2, 1, 4>{});
  if (k <= 16) return fn(MatShape<4, 1, 4>{});
  if (k <= 32) return fn(MatShape<8, 1, 4>{});
  if (k <= 64) return fn(MatShape<16, 1, 4>{});
  return fn(MatShape<32, 1, 4>{});
}

template <typename V, typename L>
cudaError_t launch_spmm(int route, const MatArgs<V, L>& a,
                        cudaStream_t stream) {
  if (route != kRelsl && !(route == kSplit && a.slice != nullptr)) {
    return cudaErrorInvalidValue;
  }
  return with_mat_shape(a.k, [&](auto shape) {
    using Sh = decltype(shape);
    MatKernel<V, L> kernel =
        route == kRelsl ? sell_spmm_kernel<Sh::kT, Sh::kW, Sh::kP, V, L>
                        : sell_split_spmm_kernel<Sh::kT, Sh::kW, Sh::kP, V, L>;
    return launch_mat<Sh>(kernel, a, stream);
  });
}

// The N-iteration kernel of a column shape.
template <typename V, typename L, class Shape>
MatKernel<V, L> bench_spmm_kernel(Shape) {
  return sell_bench_spmm_kernel<Shape::kT, Shape::kW, Shape::kP, V, L>;
}

template <typename V, typename L>
cudaError_t launch_bench_spmm(MatArgs<V, L> a, int device,
                              cudaStream_t stream) {
  if (a.iterations < 1 || a.n_out % 4) return cudaErrorInvalidValue;
  return with_mat_shape(a.k, [&](auto shape) {
    using Sh = decltype(shape);
    long long items = 0, col_blocks = 0;
    cudaError_t err = mat_work<Sh>(a, &items, &col_blocks);
    if (err != cudaSuccess) return err;
    if (items * col_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(a.out) % 16) {
      return cudaErrorMisalignedAddress;
    }
    const auto kernel = bench_spmm_kernel<V, L>(shape);
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

}  // namespace

// route: sell::kRelsl (merged word; slice null) or sell::kSplit.
// value_kind: 0 = float32, 1 = bfloat16 (vals and X). lidx_kind: 0 = int8,
// 1 = int32. X has k columns, Y is (n_slices * 128, k) float32, zeroed.
// A values plane not aligned to four elements, or (k % 4 == 0) X not
// aligned to four elements or Y to 16 bytes, returns
// cudaErrorMisalignedAddress; planes that are not whole chunks, or of no
// sublane, cudaErrorInvalidValue. Neither launches anything.
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

// The merged-word N-iteration kernel; n_out = n_slices * 128 * k, and y
// holds kBenchMatYBuffers * n_out floats (the result in buffer
// (iterations - 1) % kBenchMatYBuffers), all of each buffer zeroed before
// it is swept. The forward kernel's refusals, and a y not aligned to 16
// bytes returns cudaErrorMisalignedAddress.
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

// Blocks of one sell_bench_spmm_kernel launch with k columns on this
// device (SMs x co-resident blocks of k's column shape).
extern "C" int sell_bench_spmm_blocks(int k, int value_kind, int lidx_kind,
                                      int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = sell::with_types(value_kind, lidx_kind, [&](auto v, auto l) {
    using V = typename decltype(v)::type;
    using L = typename decltype(l)::type;
    return with_mat_shape(k, [&](auto shape) {
      return cooperative_grid(bench_spmm_kernel<V, L>(shape), device,
                              blocks);
    });
  });
  return static_cast<int>(err);
}
