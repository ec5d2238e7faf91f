// SELL-T1 packed-plane kernels for Hopper (sm_90a), bf16 value mode:
// val‖rel‖lane in ONE int32 word per slot.
//
// Replaces the packed launches of the JAX package's ops/spmv_pallas.py
// (SMVP_SELL_PACK=1):
//   sell_packed_kernel       <- _make_sell_kernel_packed (K5) with
//                               _unpack_plane, k = 1: resident y (launched
//                               :1256 resident x, :1283 prefetch x) and
//                               streamed y (:1239)
//   sell_packed_spmm_kernel  <- _make_sell_kernel_packed with k > 1,
//                               resident y (K5 fused SpMM)
//   sell_bench_packed_kernel <- _make_sell_kernel_bench, packed branch
//                               :765-771 (launched :2297; K2-packed)
// The word (SellSpMV packed_plane_host): bf16 value bits in 16..31, rel in
// 7..15 (511 = dead), lane index in 0..6; the slice id comes from the
// per-sublane slice_of plane (-1 = dead; block-local on a streamed plan).
// The value is __uint_as_float(w & 0xFFFF0000), exactly the bf16 value the
// split planes hold, and x is bf16 as on every bf16 route, so each product
// is bit-equal to K1 bf16's; only the summation order differs (float
// atomics). The slot body, the y policies, the k-column warp walk and the
// N-iteration loop are sell_common.cuh's, under its PackedWord decode
// policy: this file only instantiates and launches them.
//
// Bound on this card: bytes. One launch reads 4 bytes per slot (the word,
// padding slots included), one slice id per sublane, tile_base (and
// y_block_id when streamed) per chunk, x once, and writes y once
// (SellPlan.traffic_bytes with packed=True). That is about 4.03 bytes per
// slot against the merged word's 3.03 (bf16 value, int8 lane, one word per
// 128 slots), so this route moves a third more bytes than K1 bf16. The
// TPU packed the planes to cut its DMA stream count (spmv_pallas.py:
// 109-114), which has no counterpart here; the route is kept for parity
// and measured, not tuned.
//
// C interface (ctypes): each launch function returns a cudaError_t value,
// 0 on success, from cudaGetLastError() right after the launch. Pointers
// and the stream come in as void*, sizes as long long. The caller's stream
// is PyTorch's current stream; nothing here allocates or synchronises. The
// caller zeroes y (Y) before a forward launch.

#include "sell_common.cuh"

namespace {

using namespace sell;

using X = __nv_bfloat16;  // x and X are bf16; the word carries the value
using L = int8_t;         // unused: the lane index rides in the word

template <class YAddr>
__global__ void __launch_bounds__(kThreads)
    sell_packed_kernel(const Args<X, L> a) {
  forward_sweep<PackedWord, YAddr>(a);
}

__global__ void __launch_bounds__(kThreads)
    sell_packed_spmm_kernel(const MatArgs<X, L> a) {
  mat_sweep<PackedWord>(a);
}

__global__ void __launch_bounds__(kThreads)
    sell_bench_packed_kernel(const Args<X, L> a) {
  bench_sweeps<PackedWord, ResidentY>(a);
}

cudaError_t grid_blocks(long long n_slots, unsigned* blocks) {
  const long long b = (n_slots + kThreads - 1) / kThreads;
  if (b < 1 || b > 0x7fffffffLL) return cudaErrorInvalidValue;
  *blocks = static_cast<unsigned>(b);
  return cudaSuccess;
}

template <class A>
cudaError_t launch(const void* kernel, A a, long long n_slots,
                   cudaStream_t stream) {
  unsigned blocks = 0;
  cudaError_t err = grid_blocks(n_slots, &blocks);
  if (err != cudaSuccess) return err;
  void* params[] = {&a};
  err = cudaLaunchKernel(kernel, dim3(blocks), dim3(kThreads), params, 0,
                         stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

Args<X, L> packed_args(const void* packed, const void* slice_of,
                       const void* tile_base, const void* y_block_id,
                       const void* x, void* y, long long n_slots,
                       long long n_out, int chunk, int nsb, int iterations) {
  return make_args<X, L>(nullptr, nullptr, packed, slice_of, tile_base,
                         y_block_id, x, y, n_slots, n_out, chunk, nsb,
                         iterations);
}

}  // namespace

// k = 1: y = A·x. y_block_id null: resident y; else streamed y with nsb
// slices per block (slice_of block-local).
extern "C" int sell_packed_launch(const void* packed, const void* slice_of,
                                  const void* tile_base,
                                  const void* y_block_id, const void* x,
                                  void* y, long long n_slots, int chunk,
                                  int nsb, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (y_block_id != nullptr && nsb < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args<X, L> a = packed_args(packed, slice_of, tile_base, y_block_id,
                                   x, y, n_slots, 0, chunk, nsb, 0);
  const void* kernel =
      y_block_id == nullptr
          ? reinterpret_cast<const void*>(sell_packed_kernel<ResidentY>)
          : reinterpret_cast<const void*>(sell_packed_kernel<StreamedY>);
  return static_cast<int>(
      launch(kernel, a, n_slots, static_cast<cudaStream_t>(stream)));
}

// k > 1, resident y: Y (n_slices * 128, k) float32, zeroed, from X (at
// least CT * 128 rows, k columns, bf16).
extern "C" int sell_packed_spmm_launch(const void* packed,
                                       const void* slice_of,
                                       const void* tile_base, const void* x,
                                       void* y, long long n_slots, int chunk,
                                       int k, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const MatArgs<X, L> a{nullptr,
                        nullptr,
                        static_cast<const int*>(packed),
                        static_cast<const int*>(slice_of),
                        static_cast<const int*>(tile_base),
                        static_cast<const X*>(x),
                        nullptr,
                        static_cast<float*>(y),
                        n_slots,
                        0,
                        chunk,
                        k,
                        0};
  return static_cast<int>(
      launch(reinterpret_cast<const void*>(sell_packed_spmm_kernel), a,
             n_slots, static_cast<cudaStream_t>(stream)));
}

// N k = 1 sweeps in one cooperative launch (resident y); n_out = the y
// length, all of which is zeroed each iteration.
extern "C" int sell_bench_packed_launch(const void* packed,
                                        const void* slice_of,
                                        const void* tile_base, const void* x,
                                        void* y, long long n_slots,
                                        long long n_out, int chunk,
                                        int iterations, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (iterations < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args<X, L> a = packed_args(packed, slice_of, tile_base, nullptr, x, y,
                             n_slots, n_out, chunk, 0, iterations);
  int blocks = 0;
  err = cooperative_grid(sell_bench_packed_kernel, device, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(sell_bench_packed_kernel), dim3(blocks),
      dim3(kThreads), params, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of one sell_bench_packed_kernel launch on this device.
extern "C" int sell_bench_packed_blocks(int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cooperative_grid(sell_bench_packed_kernel, device, blocks));
}
