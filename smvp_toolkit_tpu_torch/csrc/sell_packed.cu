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
//                               resident y (K5 fused SpMM; launched
//                               resident :1256 and :1283)
//   sell_bench_packed_kernel <- _make_sell_kernel_bench, packed branch
//                               :765-771 (launched :2297; K2-packed)
// The word (SellSpMV packed_plane_host): bf16 value bits in 16..31, rel in
// 7..15 (511 = dead), lane index in 0..6; the slice id comes from the
// per-sublane slice_of plane (-1 = dead; block-local on a streamed plan).
// The value is __uint_as_float(w & 0xFFFF0000), exactly the bf16 value the
// split planes hold, and x is bf16 as on every bf16 route, so each product
// is bit-equal to K1 bf16's; only the summation order differs (float
// atomics).
//
// K5 (k = 1) runs the warp-per-sublane body of K1 (sell_common.cuh,
// sublane_sweep) under the PackedStage policy: a block per run of 64
// sublanes of one chunk stages each sublane's rel from its lane-0 word
// (the JAX _unpack_plane reads rel from lane 0 only) and its slice from
// slice_of, once per sublane; a warp per live sublane loads four words a
// thread with one 16-byte streaming load, decodes value and lane, gathers
// x in bf16 and adds four rows with one float4 atomic. Before, it ran one
// thread per slot (slot over PackedWord, decoding rel per slot),
// paying per slot a 64-bit divide, the slice and tile_base loads and a
// scalar atomic: 0.114669 ms at smoke-packed and 0.517915 ms at L1-packed
// against torch.sparse.mm's 0.061298 and 0.250741 (NVIDIA H100 80GB HBM3,
// 700 W, chip_smoke.py).
//
// K2-packed runs K2's N-iteration body
// (sublane_bench_sweeps<PackedShuffle, ResidentY, kPackedBenchYBuffers>,
// the (chunk, run) work items in a grid-stride loop over a cooperative
// grid of eight blocks an SM) with two y buffers in turn: iteration `it`
// sweeps into buffer it % 2 while it zeroes the other, one grid.sync() an
// iteration, the result in buffer (N - 1) % 2. Its policy, PackedShuffle,
// is K5's function without K5's staging load of lane 0's word: the block
// stages the slice alone, and each warp takes rel from the lane-0 word it
// has just loaded by one __shfl_sync. Timed against the staged form on
// smoke-packed at N = 200 (bench/bench_variants.py --packed), it was 2.9%
// faster (9.18-9.24 against 9.47 ms, NVIDIA H100 80GB HBM3, 700 W), with
// the same result on a plane whose lanes disagree with lane 0. Before, it
// ran one thread per slot (bench_sweeps over PackedWord: rel decoded per
// slot, one y zeroed between two grid.sync()s an iteration): 19.52 ms at
// smoke-packed, N = 200, against 200 calls of torch.sparse.mm at 12.32 ms
// (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py).
//
// K5 with k columns runs the k-column body of K1 with k columns
// (sell_common.cuh, sublane_mat_sweep under PackedShuffle, the column
// shape of with_mat_shape, __launch_bounds__(kThreads, kMatMinBlocks): 64
// registers): a block per work item and column block stages each
// sublane's slice; step 1 loads four words a thread with one 16-byte
// read-only load, takes rel from the lane-0 word by one __shfl_sync (a
// dead one clears the sublane's mask) and ballots the nonzero value bits,
// step 2 cuts runs of one slice's sublanes, and step 3 sums
// each unit's products (one read-only load of the slot's word, hitting
// the line step 1 brought into L1; X gathered four bf16 in 8 bytes where
// k % 4 == 0) in registers before one vector atomic a row and four
// columns. Only nonzero values are multiplied, so an Inf in X at a padding
// lane's column never reaches Y. Before, it ran one thread per slot (a
// warp walking its live slots one at a time, a scalar atomic per product
// and column, rel from the lane-0 word: mat_sweep under PackedLaneZero, a
// variant now, csrc/variants/sell_packed_variants.cu): 0.741034 ms at
// smoke-packed, k = 8, against torch.sparse.mm's 0.645816 (NVIDIA H100
// 80GB HBM3, 700 W, chip_smoke.py); on this body 0.1336 ms, 0.21x the
// library (bench/bench_variants.py --packed, same card), and 0.9-1.0%
// slower again with rel staged from lane 0's word (PackedStage, as K5),
// the form timed against it. No kernel here decodes rel from a slot's own
// word: on a plane whose lanes disagree with lane 0, that decode missed
// the plain version by 1.36-1.43 of max |y|.
//
// Bound on this card: bytes. One launch reads 4 bytes per slot (the word,
// padding slots included), one slice id per sublane, tile_base (and
// y_block_id when streamed) per chunk, x once, and writes y once
// (SellPlan.traffic_bytes with packed=True). That is about 4.03 bytes per
// slot against the merged word's 3.03 (bf16 value, int8 lane, one word per
// 128 slots), so this route moves a third more bytes than K1 bf16 and is
// not expected to beat it. The TPU packed the planes to cut its DMA stream
// count (spmv_pallas.py:109-114), which has no counterpart here; the route
// is kept for parity. K2-packed re-reads the planes every iteration (they
// exceed the 50 MB L2 at smoke-packed's 103 MB), so N times those bytes
// over the memory rate is its least time; on top an iteration pays one
// buffer's zeroing, one grid.sync() and the walk's static tail. K5 with k
// columns also gathers X rows and adds into Y rows of k columns; at k = 8
// the latency of those gathers and atomics, not the bytes, sets its time,
// as it sets K1 with k columns' (csrc/sell_spmm.cu).
//
// C interface (ctypes): each launch function returns a cudaError_t value,
// 0 on success, from cudaGetLastError() right after the launch. Pointers
// and the stream come in as void*, sizes as long long. The caller's stream
// is PyTorch's current stream; nothing here allocates or synchronises. The
// caller zeroes y (Y) before a forward launch. K5 and K2-packed refuse,
// launching nothing, a packed plane or y not aligned to 16 bytes
// (cudaErrorMisalignedAddress) and planes that are not whole chunks or
// hold no sublane (cudaErrorInvalidValue; K2-packed also a y length that
// is not a multiple of four); K5 with k columns a packed plane not aligned
// to 16 bytes or, where k % 4 == 0, X not aligned to four elements or Y to
// 16 bytes (cudaErrorMisalignedAddress), and planes that are not whole
// chunks or hold no sublane, or more than 65,535 column blocks
// (cudaErrorInvalidValue). A view of the planes cut at chunk boundaries
// stays aligned (512 bytes a sublane).

#include "sell_common.cuh"

namespace {

using namespace sell;

using X = __nv_bfloat16;  // x and X are bf16; the word carries the value
using L = int8_t;         // unused: the lane index rides in the word

template <class YAddr>
__global__ void __launch_bounds__(kThreads, kSublaneMinBlocks)
    sell_packed_kernel(const Args<X, L> a) {
  sublane_sweep<PackedStage, YAddr>(a);
}

template <int T, int W, int P>
__global__ void __launch_bounds__(kThreads, kMatMinBlocks)
    sell_packed_spmm_kernel(const MatArgs<X, L> a) {
  sublane_mat_sweep<PackedShuffle, MatShape<T, W, P>>(a);
}

// y buffers of K2-packed (ops/spmv_sell.py, PACKED_BENCH_Y_BUFFERS,
// allocates them; the result is buffer (N - 1) % kPackedBenchYBuffers).
constexpr int kPackedBenchYBuffers = 2;

__global__ void __launch_bounds__(kThreads, kSublaneMinBlocks)
    sell_bench_packed_kernel(const Args<X, L> a) {
  sublane_bench_sweeps<PackedShuffle, ResidentY, kPackedBenchYBuffers>(a);
}

// The warp-per-sublane body's 16-byte loads of the packed plane and its
// float4 atomics into y.
bool packed_aligned(const Args<X, L>& a) {
  const auto at16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return at16(a.meta) && at16(a.y);
}

// One block per work item of the warp-per-sublane body: the packed plane
// and y aligned to 16 bytes, whole chunks.
cudaError_t launch_packed(const void* kernel, Args<X, L> a,
                          cudaStream_t stream) {
  if (!packed_aligned(a)) return cudaErrorMisalignedAddress;
  long long items = 0;
  if (!sublane_items(a, &items)) return cudaErrorInvalidValue;
  void* params[] = {&a};
  cudaError_t err = cudaLaunchKernel(kernel, dim3(static_cast<unsigned>(items)),
                                     dim3(kThreads), params, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

MatArgs<X, L> packed_mat_args(const void* packed, const void* slice_of,
                              const void* tile_base, const void* x, void* y,
                              long long n_slots, int chunk, int k) {
  return MatArgs<X, L>{nullptr,
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
}

// One block per work item and column block of the k-column body at k's
// column shape (the checks of mat_work on the packed plane).
cudaError_t launch_packed_spmm(const MatArgs<X, L>& a, cudaStream_t stream) {
  if (a.slice == nullptr) return cudaErrorInvalidValue;
  return with_mat_shape(a.k, [&](auto shape) {
    using Sh = decltype(shape);
    return launch_mat<Sh, PackedShuffle>(
        sell_packed_spmm_kernel<Sh::kT, Sh::kW, Sh::kP>, a, stream);
  });
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
// slices per block (slice_of block-local). Misaligned planes return
// cudaErrorMisalignedAddress, planes that are not whole chunks (or hold no
// sublane) cudaErrorInvalidValue.
extern "C" int sell_packed_launch(const void* packed, const void* slice_of,
                                  const void* tile_base,
                                  const void* y_block_id, const void* x,
                                  void* y, long long n_slots, int chunk,
                                  int nsb, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((y_block_id != nullptr && nsb < 1) || slice_of == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args<X, L> a = packed_args(packed, slice_of, tile_base, y_block_id,
                                   x, y, n_slots, 0, chunk, nsb, 0);
  const void* kernel =
      y_block_id == nullptr
          ? reinterpret_cast<const void*>(sell_packed_kernel<ResidentY>)
          : reinterpret_cast<const void*>(sell_packed_kernel<StreamedY>);
  return static_cast<int>(
      launch_packed(kernel, a, static_cast<cudaStream_t>(stream)));
}

// k > 1, resident y: Y (n_slices * 128, k) float32, zeroed, from X (at
// least CT * 128 rows, k columns, bf16). A packed plane not aligned to 16
// bytes, or (k % 4 == 0) X not aligned to four elements or Y to 16 bytes,
// returns cudaErrorMisalignedAddress; planes that are not whole chunks (or
// hold no sublane), or more than 65,535 column blocks,
// cudaErrorInvalidValue. Neither launches anything.
extern "C" int sell_packed_spmm_launch(const void* packed,
                                       const void* slice_of,
                                       const void* tile_base, const void* x,
                                       void* y, long long n_slots, int chunk,
                                       int k, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_packed_spmm(
      packed_mat_args(packed, slice_of, tile_base, x, y, n_slots, chunk, k),
      static_cast<cudaStream_t>(stream)));
}

// N k = 1 sweeps in one cooperative launch (resident y); n_out = the
// length of one y buffer. y holds kPackedBenchYBuffers buffers of n_out
// floats, and the result is buffer (iterations - 1) %
// kPackedBenchYBuffers. A packed plane or y not aligned to 16 bytes
// returns cudaErrorMisalignedAddress; planes that are not whole chunks (or
// hold no sublane), or n_out % 4 != 0, cudaErrorInvalidValue.
extern "C" int sell_bench_packed_launch(const void* packed,
                                        const void* slice_of,
                                        const void* tile_base, const void* x,
                                        void* y, long long n_slots,
                                        long long n_out, int chunk,
                                        int iterations, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (iterations < 1 || slice_of == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args<X, L> a = packed_args(packed, slice_of, tile_base, nullptr, x, y,
                             n_slots, n_out, chunk, 0, iterations);
  if (!packed_aligned(a)) return static_cast<int>(cudaErrorMisalignedAddress);
  long long items = 0;
  if (!sublane_items(a, &items) || n_out % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
