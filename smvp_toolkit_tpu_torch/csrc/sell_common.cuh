// One slot of the SELL-T1 SpMV, shared by every forward and bench kernel
// (csrc/sell_spmv.cu, csrc/sell_bench.cu, csrc/sell_packed.cu); its decode
// policies, the slot coordinates, the warp walk over k columns and the
// cooperative grid also serve the k-column kernels (csrc/sell_spmm.cu,
// csrc/sell_vals_grad.cu) and the fused solvers (csrc/sell_solvers.cu).
//
// Per live slot (s, l) of the (S, 128) planes, with c = s / chunk:
//   y[(ybase(c) + slice(s)) * 128 + l] +=
//       vals[s, l] * x[(tile_base[c] + rel(s)) * 128 + lidx[s, l]]
// Two policies pick the kernel's route:
//   * how a slot's rel, slice, value and lane index are decoded: the
//     merged rel‖slice word per sublane (rel in bits 0..8, 511 = dead;
//     slice in bits 9..31, all ones = dead) beside the values and lane
//     planes; the split rel_tile and slice_of planes (int32 each, -1 =
//     dead) beside the same two planes; or the packed val‖rel‖lane word
//     per slot (bf16 value bits in 16..31, rel in 7..15 with 511 = dead,
//     lane in 0..6) beside the slice_of plane;
//   * how y is addressed: resident (ybase = 0) or block-streamed
//     (ybase = y_block_id[c] * nsb, slice ids local to the block).
// A sublane is dead when rel OR slice is dead: the planner gives dead
// padding sublanes the last real tile, so their rel is live and only the
// slice marks them.
//
// One thread per slot: 128 consecutive threads cover one sublane, so the
// plane loads are coalesced and the sublane's metadata is one broadcast
// load. The x value is gathered directly and the product lands in y with
// a float atomicAdd (summation order varies from run to run: compare y
// with a tolerance, never bitwise). Zero products (padding slots) skip
// the atomic; NaN and Inf products still land. Values are f32 or bf16
// storage, products and sums f32. Tile, column, slot and row indices are
// 64-bit: a window may span the whole column range (rel then needs the
// full int32) and plans of 180M slots occur.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace sell {

constexpr int kLanes = 128;
constexpr unsigned kRelDead = 511u;
constexpr int kSliceShift = 9;
constexpr unsigned kSliceDead = (1u << 23) - 1u;
constexpr int kThreads = 256;

// Route ids shared with ops/spmv_sell.py (_ROUTE_IDS).
enum Route : int {
  kRelsl = 0,         // merged word, resident y   (K1, K2)
  kStreamyRelsl = 1,  // merged word, streamed y   (K3-relsl, K2 streamed)
  kStreamy = 2,       // split planes, streamed y  (K3-split, K2 streamed split)
  kSplit = 3,         // split planes, resident y  (K4, K2 split)
};

// Everything a kernel reads, passed by value as its one parameter.
template <typename V, typename L>
struct Args {
  const V* vals;
  const L* lidx;
  const int* meta;        // merged word, rel_tile (split) or packed word
  const int* slice;       // slice_of (split and packed routes only)
  const int* tile_base;   // per chunk
  const int* y_block_id;  // per chunk (streamed routes only)
  const V* x;
  float* y;
  long long n_slots;      // S * 128
  long long n_out;        // y length, n_slices * 128
  int chunk;
  int nsb;                // slices per y block (streamed routes)
  int iterations;         // bench kernels only
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// The values and lane-index planes (merged word and split planes).
struct ValuePlanes {
  template <class A>
  __device__ __forceinline__ static float value(const A& a, long long i) {
    return to_f32(a.vals[i]);
  }
  template <class A>
  __device__ __forceinline__ static long long lane_index(const A& a,
                                                         long long i) {
    return static_cast<long long>(a.lidx[i]);
  }
};

// Each policy decodes slot i: false when its sublane is dead, else its
// rel and slice; value() and lane_index() read the slot's value and lane.
struct MergedWord : ValuePlanes {
  template <class A>
  __device__ __forceinline__ static bool decode(const A& a, long long i,
                                                long long* rel,
                                                long long* slice) {
    const unsigned word = static_cast<unsigned>(a.meta[i >> 7]);
    const unsigned r = word & kRelDead;
    const unsigned sl = word >> kSliceShift;
    if (r == kRelDead || sl == kSliceDead) return false;
    *rel = r;
    *slice = sl;
    return true;
  }
};

struct SplitPlanes : ValuePlanes {
  template <class A>
  __device__ __forceinline__ static bool decode(const A& a, long long i,
                                                long long* rel,
                                                long long* slice) {
    const int r = a.meta[i >> 7];
    const int sl = a.slice[i >> 7];
    if (r < 0 || sl < 0) return false;
    *rel = r;
    *slice = sl;
    return true;
  }
};

// The packed word per slot in meta, slice_of per sublane in slice; the
// value is the word's high half, which is the bf16 value's float32 bits.
constexpr int kPackRelShift = 7;
constexpr unsigned kPackLaneMask = 127u;
constexpr unsigned kPackValueMask = 0xFFFF0000u;

struct PackedWord {
  template <class A>
  __device__ __forceinline__ static bool decode(const A& a, long long i,
                                                long long* rel,
                                                long long* slice) {
    const unsigned r =
        (static_cast<unsigned>(a.meta[i]) >> kPackRelShift) & kRelDead;
    const int sl = a.slice[i >> 7];
    if (r == kRelDead || sl < 0) return false;
    *rel = r;
    *slice = sl;
    return true;
  }
  template <class A>
  __device__ __forceinline__ static float value(const A& a, long long i) {
    return __uint_as_float(static_cast<unsigned>(a.meta[i]) &
                           kPackValueMask);
  }
  template <class A>
  __device__ __forceinline__ static long long lane_index(const A& a,
                                                         long long i) {
    return static_cast<long long>(static_cast<unsigned>(a.meta[i]) &
                                  kPackLaneMask);
  }
};

struct ResidentY {
  template <class A>
  __device__ __forceinline__ static long long base(const A&, long long) {
    return 0;
  }
};

struct StreamedY {
  template <class A>
  __device__ __forceinline__ static long long base(const A& a, long long c) {
    return static_cast<long long>(a.y_block_id[c]) * a.nsb;
  }
};

template <class Decode, class YAddr, typename V, typename L>
__device__ __forceinline__ void slot(const Args<V, L>& a, long long i) {
  const long long lane = i & (kLanes - 1);
  long long rel, slice;
  if (!Decode::decode(a, i, &rel, &slice)) return;
  const long long c = (i >> 7) / a.chunk;
  const long long col =
      (static_cast<long long>(a.tile_base[c]) + rel) * kLanes +
      Decode::lane_index(a, i);
  const float p = Decode::value(a, i) * to_f32(a.x[col]);
  if (p != 0.0f) {
    atomicAdd(a.y + (YAddr::base(a, c) + slice) * kLanes + lane, p);
  }
}

// The forward kernels' body: slot i of a one-thread-per-slot grid.
template <class Decode, class YAddr, typename V, typename L>
__device__ __forceinline__ void forward_sweep(const Args<V, L>& a) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < a.n_slots) slot<Decode, YAddr>(a, i);
}

// The N-iteration kernels' body (one cooperative launch): each iteration
// zeroes ALL of y in a grid-stride loop, grid.sync(), sweeps every slot,
// grid.sync(). The TPU grid runs in order and re-zeroes y when an
// iteration (or, streamed, a y block) starts; on Hopper blocks run in no
// order, and zeroing all of y keeps a block that no chunk visits at zero.
template <class Decode, class YAddr, typename V, typename L>
__device__ __forceinline__ void bench_sweeps(const Args<V, L>& a) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
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

// Everything a k-column kernel reads (csrc/sell_spmm.cu,
// csrc/sell_vals_grad.cu). X, Y and G are row-major (rows, k): row r's k
// values are contiguous, element (r, j) at r * k + j. Resident y only.
template <typename V, typename L>
struct MatArgs {
  const V* vals;          // null for the values-gradient kernel
  const L* lidx;
  const int* meta;        // merged word, rel_tile (split) or packed word
  const int* slice;       // slice_of (split and packed planes only)
  const int* tile_base;   // per chunk
  const V* x;             // X, at least CT * 128 rows
  const float* g;         // G, at least NS * 128 rows (values gradient)
  float* out;             // Y (NS * 128, k), or the (S, 128) gradient
  long long n_slots;      // S * 128
  long long n_out;        // Y elements, NS * 128 * k (bench kernel)
  int chunk;
  int k;                  // columns of X, Y and G
  int iterations;         // bench kernel only
};

// Column and row of slot i, false when its sublane is dead.
template <class Decode, class A>
__device__ __forceinline__ bool slot_coords(const A& a, long long i,
                                            long long* col, long long* row) {
  long long rel, slice;
  if (!Decode::decode(a, i, &rel, &slice)) return false;
  const long long c = (i >> 7) / a.chunk;
  *col = (static_cast<long long>(a.tile_base[c]) + rel) * kLanes +
         Decode::lane_index(a, i);
  *row = slice * kLanes + (i & (kLanes - 1));
  return true;
}

constexpr unsigned kFull = 0xffffffffu;

// The k-column kernels' warp walk: the warp of slot i adds its live
// nonzero slots' products into Y. One thread decodes each slot (the plane
// loads stay coalesced); the warp ballots its live nonzero slots and walks
// them one at a time, the slot's value, X row and Y row broadcast with
// __shfl_sync, its 32 lanes covering the k columns 32 at a time (float
// atomics). All 32 lanes must call it (n_slots is a multiple of 128, so a
// warp's slots are all in range or all out of range).
template <class Decode, typename V, typename L>
__device__ __forceinline__ void warp_slots(const MatArgs<V, L>& a,
                                           long long i) {
  const int lane = threadIdx.x & 31;
  long long col = 0, row = 0;
  float v = 0.0f;
  bool live = slot_coords<Decode>(a, i, &col, &row);
  if (live) {
    v = Decode::value(a, i);
    live = v != 0.0f;
  }
  const long long k = a.k;
  unsigned todo = __ballot_sync(kFull, live);
  while (todo) {
    const int t = __ffs(todo) - 1;
    todo &= todo - 1;
    const float vt = __shfl_sync(kFull, v, t);
    const V* xr = a.x + __shfl_sync(kFull, col, t) * k;
    float* yr = a.out + __shfl_sync(kFull, row, t) * k;
    for (long long j = lane; j < k; j += 32) {
      atomicAdd(yr + j, vt * to_f32(xr[j]));
    }
  }
}

// The k-column forward sweep: the warps of a one-thread-per-slot grid.
template <class Decode, typename V, typename L>
__device__ __forceinline__ void mat_sweep(const MatArgs<V, L>& a) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if ((i & ~31LL) < a.n_slots) warp_slots<Decode>(a, i);
}

// The k-column N-iteration body (one cooperative launch), zeroing all of
// Y between grid.sync()s before each sweep, as bench_sweeps.
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

// Blocks of a cooperative launch of `kernel` with kThreads threads: SMs x
// co-resident blocks per SM (a larger grid fails at launch, not at the
// grid.sync()).
template <class Kernel>
cudaError_t cooperative_grid(Kernel kernel, int device, int* blocks) {
  if (kernel == nullptr) return cudaErrorInvalidValue;
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
      &per_sm, reinterpret_cast<const void*>(kernel), kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = sms * per_sm;
  return cudaSuccess;
}

template <typename T>
struct Tag {
  using type = T;
};

// Calls fn(Tag<V>, Tag<L>) for value_kind (0 = float32, 1 = bfloat16) and
// lidx_kind (0 = int8, 1 = int32).
template <typename Fn>
cudaError_t with_types(int value_kind, int lidx_kind, Fn&& fn) {
  if (value_kind < 0 || value_kind > 1 || lidx_kind < 0 || lidx_kind > 1) {
    return cudaErrorInvalidValue;
  }
  switch (value_kind * 2 + lidx_kind) {
    case 0: return fn(Tag<float>{}, Tag<int8_t>{});
    case 1: return fn(Tag<float>{}, Tag<int32_t>{});
    case 2: return fn(Tag<__nv_bfloat16>{}, Tag<int8_t>{});
    default: return fn(Tag<__nv_bfloat16>{}, Tag<int32_t>{});
  }
}

template <typename V, typename L>
Args<V, L> make_args(const void* vals, const void* lidx, const void* meta,
                     const void* slice, const void* tile_base,
                     const void* y_block_id, const void* x, void* y,
                     long long n_slots, long long n_out, int chunk, int nsb,
                     int iterations) {
  return Args<V, L>{static_cast<const V*>(vals),
                    static_cast<const L*>(lidx),
                    static_cast<const int*>(meta),
                    static_cast<const int*>(slice),
                    static_cast<const int*>(tile_base),
                    static_cast<const int*>(y_block_id),
                    static_cast<const V*>(x),
                    static_cast<float*>(y),
                    n_slots,
                    n_out,
                    chunk,
                    nsb,
                    iterations};
}

}  // namespace sell

// Each library built from a source that includes this header exports it.
extern "C" const char* sell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
