// SELL-T1 SpMV kernels for Hopper (sm_90a): K1 forward, K2 N-iteration bench.
//
// Replaces two Pallas TPU kernels of the JAX package's ops/spmv_pallas.py:
//   K1 sell_spmv_kernel  <- _make_sell_kernel_relsl (+ _relsl_chain_store)
//   K2 sell_bench_kernel <- _make_sell_kernel_bench, relsl branch
//
// What they compute, per live slot (s, l) of the (S, 128) planes:
//   y[slice * 128 + l] += vals[s, l] * x[(tile_base[s / chunk] + rel) * 128 + lidx[s, l]]
// with rel = relsl[s] & 511 and slice = (unsigned)relsl[s] >> 9. A sublane
// is dead when rel == 511 OR slice == 2^23 - 1: the planner gives dead
// padding sublanes the last real tile, so their rel is live and only the
// slice field marks them.
//
// The TPU kernel's one-hot MXU table select and one-hot row reduce exist
// because the TPU has no fast gather or scatter. Hopper has both, so each
// thread gathers its x value directly and scatters its product with a
// float atomicAdd. One thread per slot: 128 consecutive threads cover one
// sublane, so the vals/lidx loads are coalesced and the sublane's relsl
// word is one broadcast load. Within a sublane the 128 lanes hit 128
// distinct rows, so atomics collide only across sublanes of one slice.
// Summation order therefore varies from run to run; compare y with a
// tolerance, never bitwise. Values are f32 or bf16 storage (bf16 read
// with __bfloat162float); products and sums are f32. Indices are 64-bit.
//
// Bound on this card: bytes. One K1 launch must read the vals and lane
// index planes (S * 128 * (value + index bytes), padding slots included),
// one relsl word per sublane, tile_base, x once, and write y once
// (SellPlan.traffic_bytes). For synth:1000000:10000000 at chunk 2048
// (S = 188,416, CT = 7,936, NS = 7,824) that is 129,409,392 bytes with f32
// values and 79,143,280 with bf16; the arithmetic, 2 flops per nonzero, is
// far below the card's rate. The design reads each plane byte once per
// launch and skips the atomic for zero products (padding slots), which are
// most of the planes at this occupancy.
//
// K2 runs N back-to-back K1 sweeps in one cooperative launch: zero y,
// grid-wide sync, sweep, grid-wide sync, N times; it returns the last y.
// The planes are re-read every iteration, as in the TPU kernel; at the
// sizes above they exceed the 50 MB L2, so its rate is a memory rate.
//
// C interface (ctypes): every entry returns a cudaError_t value, 0 on
// success, from cudaGetLastError() right after the launch. Pointers and
// the stream come in as void*, sizes as long long. The caller's stream is
// PyTorch's current stream; nothing here allocates or synchronises.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 128;
constexpr unsigned kRelDead = 511u;
constexpr int kSliceShift = 9;
constexpr unsigned kSliceDead = (1u << 23) - 1u;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One slot of the sweep: gather, multiply, scatter.
template <typename V, typename L>
__device__ __forceinline__ void sell_slot(
    long long slot, const V* __restrict__ vals, const L* __restrict__ lidx,
    const int* __restrict__ relsl, const int* __restrict__ tile_base,
    const V* __restrict__ x, float* __restrict__ y, int chunk) {
  const long long s = slot >> 7;
  const int lane = static_cast<int>(slot & (kLanes - 1));
  const unsigned word = static_cast<unsigned>(relsl[s]);
  const unsigned rel = word & kRelDead;
  const unsigned slice = word >> kSliceShift;
  if (rel == kRelDead || slice == kSliceDead) return;
  const long long tile =
      static_cast<long long>(tile_base[s / chunk]) + static_cast<long long>(rel);
  const long long col = tile * kLanes + static_cast<long long>(lidx[slot]);
  const float p = to_f32(vals[slot]) * to_f32(x[col]);
  // Adding +0 leaves y unchanged; NaN and Inf products still land.
  if (p != 0.0f) {
    atomicAdd(y + static_cast<long long>(slice) * kLanes + lane, p);
  }
}

template <typename V, typename L>
__global__ void __launch_bounds__(kThreads)
    sell_spmv_kernel(const V* __restrict__ vals, const L* __restrict__ lidx,
                     const int* __restrict__ relsl,
                     const int* __restrict__ tile_base,
                     const V* __restrict__ x, float* __restrict__ y,
                     long long n_slots, int chunk) {
  const long long slot =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (slot < n_slots) {
    sell_slot<V, L>(slot, vals, lidx, relsl, tile_base, x, y, chunk);
  }
}

template <typename V, typename L>
__global__ void __launch_bounds__(kThreads)
    sell_bench_kernel(const V* __restrict__ vals, const L* __restrict__ lidx,
                      const int* __restrict__ relsl,
                      const int* __restrict__ tile_base,
                      const V* __restrict__ x, float* __restrict__ y,
                      long long n_slots, long long n_out, int chunk,
                      int iterations) {
  cg::grid_group grid = cg::this_grid();
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (int it = 0; it < iterations; ++it) {
    for (long long i = tid; i < n_out; i += stride) y[i] = 0.0f;
    grid.sync();
    for (long long slot = tid; slot < n_slots; slot += stride) {
      sell_slot<V, L>(slot, vals, lidx, relsl, tile_base, x, y, chunk);
    }
    grid.sync();
  }
}

template <typename V, typename L>
cudaError_t launch_spmv(const void* vals, const void* lidx, const void* relsl,
                        const void* tile_base, const void* x, void* y,
                        long long n_slots, int chunk, cudaStream_t stream) {
  const long long blocks = (n_slots + kThreads - 1) / kThreads;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  sell_spmv_kernel<V, L><<<static_cast<unsigned>(blocks), kThreads, 0,
                           stream>>>(
      static_cast<const V*>(vals), static_cast<const L*>(lidx),
      static_cast<const int*>(relsl), static_cast<const int*>(tile_base),
      static_cast<const V*>(x), static_cast<float*>(y), n_slots, chunk);
  return cudaGetLastError();
}

// Co-resident block count of K2: SMs x max active blocks per SM.
template <typename V, typename L>
cudaError_t bench_grid(int device, int* blocks) {
  int coop = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sell_bench_kernel<V, L>, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = sms * per_sm;
  return cudaSuccess;
}

template <typename V, typename L>
cudaError_t launch_bench(const void* vals, const void* lidx, const void* relsl,
                         const void* tile_base, const void* x, void* y,
                         long long n_slots, long long n_out, int chunk,
                         int iterations, int device, cudaStream_t stream) {
  int blocks = 0;
  cudaError_t err = bench_grid<V, L>(device, &blocks);
  if (err != cudaSuccess) return err;
  const V* v_p = static_cast<const V*>(vals);
  const L* l_p = static_cast<const L*>(lidx);
  const int* r_p = static_cast<const int*>(relsl);
  const int* t_p = static_cast<const int*>(tile_base);
  const V* x_p = static_cast<const V*>(x);
  float* y_p = static_cast<float*>(y);
  void* args[] = {&v_p, &l_p, &r_p, &t_p, &x_p, &y_p,
                  &n_slots, &n_out, &chunk, &iterations};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(sell_bench_kernel<V, L>), dim3(blocks),
      dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// value_kind: 0 = float32, 1 = bfloat16. lidx_kind: 0 = int8, 1 = int32.
extern "C" int sell_spmv_launch(const void* vals, const void* lidx,
                                const void* relsl, const void* tile_base,
                                const void* x, void* y, long long n_slots,
                                int chunk, int value_kind, int lidx_kind,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (value_kind * 2 + lidx_kind) {
    case 0:
      err = launch_spmv<float, int8_t>(vals, lidx, relsl, tile_base, x, y,
                                       n_slots, chunk, st);
      break;
    case 1:
      err = launch_spmv<float, int32_t>(vals, lidx, relsl, tile_base, x, y,
                                        n_slots, chunk, st);
      break;
    case 2:
      err = launch_spmv<__nv_bfloat16, int8_t>(vals, lidx, relsl, tile_base,
                                               x, y, n_slots, chunk, st);
      break;
    case 3:
      err = launch_spmv<__nv_bfloat16, int32_t>(vals, lidx, relsl, tile_base,
                                                x, y, n_slots, chunk, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int sell_bench_launch(const void* vals, const void* lidx,
                                 const void* relsl, const void* tile_base,
                                 const void* x, void* y, long long n_slots,
                                 long long n_out, int chunk, int iterations,
                                 int value_kind, int lidx_kind, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (value_kind * 2 + lidx_kind) {
    case 0:
      err = launch_bench<float, int8_t>(vals, lidx, relsl, tile_base, x, y,
                                        n_slots, n_out, chunk, iterations,
                                        device, st);
      break;
    case 1:
      err = launch_bench<float, int32_t>(vals, lidx, relsl, tile_base, x, y,
                                         n_slots, n_out, chunk, iterations,
                                         device, st);
      break;
    case 2:
      err = launch_bench<__nv_bfloat16, int8_t>(vals, lidx, relsl, tile_base,
                                                x, y, n_slots, n_out, chunk,
                                                iterations, device, st);
      break;
    case 3:
      err = launch_bench<__nv_bfloat16, int32_t>(
          vals, lidx, relsl, tile_base, x, y, n_slots, n_out, chunk,
          iterations, device, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Blocks of one K2 launch on this device (for logs and the smoke test).
extern "C" int sell_bench_blocks(int value_kind, int lidx_kind, int device,
                                 int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (value_kind * 2 + lidx_kind) {
    case 0: err = bench_grid<float, int8_t>(device, blocks); break;
    case 1: err = bench_grid<float, int32_t>(device, blocks); break;
    case 2: err = bench_grid<__nv_bfloat16, int8_t>(device, blocks); break;
    case 3: err = bench_grid<__nv_bfloat16, int32_t>(device, blocks); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* sell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
