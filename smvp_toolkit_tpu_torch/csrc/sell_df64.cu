// Double-float SELL-T1 SpMV for Hopper (sm_90a): (y_hi, y_lo) ≈ A·(x_hi +
// x_lo) with f32 value planes vals_hi (+ vals_lo), the merged rel‖slice
// word and a resident y.
//
// Replaces the JAX package's ops/spmv_df64.py SellDf64SpMV._launch with
// _df64_chunk_store (K8, pallas_call :362; grid (n_chunks,), or
// (iterations, n_chunks) for bench_loop):
//   sell_df64_kernel        one SpMV
//   sell_bench_df64_kernel  N SpMVs in one cooperative launch, the last y
// The TPU has no fast float64, so its kernel selects x exactly through
// three bf16 expansions on the MXU, forms error-free products with Dekker's
// two_prod and accumulates rows exactly by quantizing the products onto
// power-of-two grids of 8-bit levels, inside a clamped band of chunk
// scales. Hopper has float64, so this kernel ports the contract, not the
// trick: the product of two float32 values is exact in float64 (24 + 24
// bits <= 53), the cross terms vh·x_lo, vl·x_hi and vl·x_lo cost one
// float64 rounding each, and each row is summed in float64 and split once
// into hi = float(y), lo = float(y - hi). That is more accurate than the
// TPU kernel (about 2^-53 of the row's running sum per term against
// 2^-49 of the chunk's product scale) and has no range clamp.
//
// Fixed summation order, no atomics: one thread per output row. A block
// of 256 threads covers two slices (128 rows each); each thread walks its
// slice's live sublanes in plan order through a host-built index
// (slice_ptr[slice] .. slice_ptr[slice + 1] into sublanes), reading its
// own lane of each (128 consecutive threads on 128 consecutive slots: the
// plane loads are coalesced). Every product and sum goes through the
// __dmul_rn / __dadd_rn intrinsics, so the compiler contracts nothing into
// an FMA and the forward and N-iteration kernels give the same bits. Dead
// sublanes are not in the index; the lo plane may be absent (null), and
// then its terms are skipped. Every y word is written, so y needs no
// zeroing.
//
// Bound on this card: bytes (SellDf64SpMV.traffic_bytes): vals_hi (and
// vals_lo) and the lane plane per slot, the merged word per sublane,
// tile_base per chunk, the index, the x pair once and the y pair once. The
// float64 work, at most 8 flops per slot, is far below the card's FP64
// rate at these sizes.
//
// C interface (ctypes): each launch function returns a cudaError_t value,
// 0 on success, from cudaGetLastError() right after the launch. The
// caller's stream is PyTorch's current stream; nothing here allocates or
// synchronises.

#include "sell_common.cuh"

namespace {

using namespace sell;

template <typename L>
struct Df64Args {
  const float* vals_hi;
  const float* vals_lo;   // null: the lo plane is elided (f32 values)
  const L* lidx;
  const int* relsl;       // merged rel‖slice word per sublane
  const int* tile_base;   // per chunk
  const int* slice_ptr;   // n_slices + 1 offsets into sublanes
  const int* sublanes;    // live sublanes, by slice, in plan order
  const float* x_hi;
  const float* x_lo;
  float* y_hi;
  float* y_lo;
  long long n_rows;       // n_slices * 128
  int chunk;
  int iterations;         // bench kernel only
};

// Row t = slice * 128 + lane: its float64 sum, split into the pair.
template <typename L>
__device__ __forceinline__ void df64_row(const Df64Args<L>& a, long long t) {
  const long long slice = t >> 7;
  const long long lane = t & (kLanes - 1);
  double acc = 0.0;
  const int end = a.slice_ptr[slice + 1];
  for (int j = a.slice_ptr[slice]; j < end; ++j) {
    const int s = a.sublanes[j];  // S < 2^31: 32-bit division below
    const long long rel =
        static_cast<unsigned>(a.relsl[s]) & kRelDead;  // live by the index
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
    sell_df64_kernel(const Df64Args<L> a) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t < a.n_rows) df64_row(a, t);
}

template <typename L>
__global__ void __launch_bounds__(kThreads)
    sell_bench_df64_kernel(const Df64Args<L> a) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (int it = 0; it < a.iterations; ++it) {
    for (long long t = tid; t < a.n_rows; t += stride) df64_row(a, t);
    grid.sync();
  }
}

template <typename L>
Df64Args<L> make_df64_args(const void* vals_hi, const void* vals_lo,
                           const void* lidx, const void* relsl,
                           const void* tile_base, const void* slice_ptr,
                           const void* sublanes, const void* x_hi,
                           const void* x_lo, void* y_hi, void* y_lo,
                           long long n_rows, int chunk, int iterations) {
  return Df64Args<L>{static_cast<const float*>(vals_hi),
                     static_cast<const float*>(vals_lo),
                     static_cast<const L*>(lidx),
                     static_cast<const int*>(relsl),
                     static_cast<const int*>(tile_base),
                     static_cast<const int*>(slice_ptr),
                     static_cast<const int*>(sublanes),
                     static_cast<const float*>(x_hi),
                     static_cast<const float*>(x_lo),
                     static_cast<float*>(y_hi),
                     static_cast<float*>(y_lo),
                     n_rows,
                     chunk,
                     iterations};
}

// Calls fn(Tag<L>) for lidx_kind 0 = int8, 1 = int32.
template <typename Fn>
cudaError_t with_lidx(int lidx_kind, Fn&& fn) {
  if (lidx_kind == 0) return fn(Tag<int8_t>{});
  if (lidx_kind == 1) return fn(Tag<int32_t>{});
  return cudaErrorInvalidValue;
}

}  // namespace

// One SpMV: y_hi, y_lo of n_rows = n_slices * 128 floats each. vals_lo may
// be null.
extern "C" int sell_df64_launch(const void* vals_hi, const void* vals_lo,
                                const void* lidx, const void* relsl,
                                const void* tile_base, const void* slice_ptr,
                                const void* sublanes, const void* x_hi,
                                const void* x_lo, void* y_hi, void* y_lo,
                                long long n_rows, int chunk, int lidx_kind,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n_rows + kThreads - 1) / kThreads;
  if (blocks < 1 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = with_lidx(lidx_kind, [&](auto l) {
    using L = typename decltype(l)::type;
    Df64Args<L> a = make_df64_args<L>(vals_hi, vals_lo, lidx, relsl,
                                      tile_base, slice_ptr, sublanes, x_hi,
                                      x_lo, y_hi, y_lo, n_rows, chunk, 0);
    void* params[] = {&a};
    cudaError_t e = cudaLaunchKernel(
        reinterpret_cast<const void*>(sell_df64_kernel<L>),
        dim3(static_cast<unsigned>(blocks)), dim3(kThreads), params, 0,
        static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
  });
  return static_cast<int>(err);
}

// N SpMVs in one cooperative launch; the pair holds the last one.
extern "C" int sell_bench_df64_launch(
    const void* vals_hi, const void* vals_lo, const void* lidx,
    const void* relsl, const void* tile_base, const void* slice_ptr,
    const void* sublanes, const void* x_hi, const void* x_lo, void* y_hi,
    void* y_lo, long long n_rows, int chunk, int iterations, int lidx_kind,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (iterations < 1) return static_cast<int>(cudaErrorInvalidValue);
  err = with_lidx(lidx_kind, [&](auto l) {
    using L = typename decltype(l)::type;
    Df64Args<L> a = make_df64_args<L>(vals_hi, vals_lo, lidx, relsl,
                                      tile_base, slice_ptr, sublanes, x_hi,
                                      x_lo, y_hi, y_lo, n_rows, chunk,
                                      iterations);
    int blocks = 0;
    cudaError_t e = cooperative_grid(sell_bench_df64_kernel<L>, device,
                                     &blocks);
    if (e != cudaSuccess) return e;
    void* params[] = {&a};
    e = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(sell_bench_df64_kernel<L>),
        dim3(blocks), dim3(kThreads), params, 0,
        static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
  });
  return static_cast<int>(err);
}

// Blocks of one sell_bench_df64_kernel launch on this device.
extern "C" int sell_bench_df64_blocks(int lidx_kind, int device,
                                      int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(with_lidx(lidx_kind, [&](auto l) {
    using L = typename decltype(l)::type;
    return cooperative_grid(sell_bench_df64_kernel<L>, device, blocks);
  }));
}
