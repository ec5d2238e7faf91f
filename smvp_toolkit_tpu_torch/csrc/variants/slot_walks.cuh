// The one-thread-per-slot walks that the package's kernels ran before they
// were redesigned on one warp per sublane (sell_common.cuh): only the
// variants in this directory include this header, to time the old walks
// against the kept kernels (smvp_toolkit_tpu_torch/bench/bench_variants.py);
// no kernel of the package runs them.
//
// One thread per slot: 128 consecutive threads cover one sublane, so the
// plane loads are coalesced and the sublane's metadata is one broadcast
// load. The x value is gathered directly and the product lands in y with
// a float atomicAdd (summation order varies from run to run). Zero
// products (padding slots) skip the atomic; NaN and Inf products still
// land. Each slot pays a 64-bit divide for its chunk, its chunk's and
// sublane's metadata loads and 64-bit address arithmetic.
//   slot, bench_sweeps  the k = 1 walk, forward and N-iteration (K1-K4,
//                       K2, K2-subwin, K5 and K2-packed ran it)
//   spmv_range          the fused solvers' SpMV phase over a slot range
//                       (K9, K10 and K11 ran it)
//   warp_slots,         the k-column warp walk (K1, K4, K2 and K5 with k
//   mat_sweep           columns ran it)
//   slot_coords         a slot's column and row (K7 ran it)
//   PackedWord,         the packed word decoded per slot, rel from the
//   PackedLaneZero      slot's own word or from its sublane's lane-0 word

#pragma once

#include "../sell_common.cuh"

namespace sell {

// The packed word decoded per slot: rel from slot i's own word (the old
// walks of K5 and K2-packed). Every kernel of the package reads a
// sublane's rel from its lane-0 word (PackedStage, PackedShuffle).
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

// The packed word with rel read from the sublane's lane-0 word, as the JAX
// _unpack_plane reads it (w[:, 0:1]); the slice from slice_of, the value
// and lane index from the slot's own word (K5 with k columns' old walk,
// mat_sweep<PackedLaneZero>). A warp's 32 slots lie in one sublane, so the
// lane-0 load is one broadcast address a warp.
struct PackedLaneZero : PackedWord {
  template <class A>
  __device__ __forceinline__ static bool decode(const A& a, long long i,
                                                long long* rel,
                                                long long* slice) {
    const unsigned r =
        (static_cast<unsigned>(a.meta[i & ~127LL]) >> kPackRelShift) &
        kRelDead;
    const int sl = a.slice[i >> 7];
    if (r == kRelDead || sl < 0) return false;
    *rel = r;
    *slice = sl;
    return true;
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

// The one-thread-per-slot N-iteration body (one cooperative launch): each
// iteration zeroes ALL of y in a grid-stride loop, grid.sync(), sweeps
// every slot, grid.sync(). The TPU grid runs in order and re-zeroes y when
// an iteration (or, streamed, a y block) starts; on Hopper blocks run in no
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

// q += A·xin over the slots [lo, hi), one thread per slot (resident y):
// the SpMV phase the fused solvers ran before.
template <class Decode, typename V, typename L>
__device__ __forceinline__ void spmv_range(const Args<V, L>& a, long long lo,
                                           long long hi, long long tid,
                                           long long stride) {
  for (long long i = lo + tid; i < hi; i += stride) {
    slot<Decode, ResidentY>(a, i);
  }
}

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

// The one-thread-per-slot k-column warp walk: the warp of slot i adds its
// live nonzero slots' products into Y. One thread decodes each slot (the
// plane loads stay coalesced); the warp ballots its live nonzero slots and
// walks them one at a time, the slot's value, X row and Y row broadcast
// with __shfl_sync, its 32 lanes covering the k columns 32 at a time
// (float atomics). All 32 lanes must call it (n_slots is a multiple of
// 128, so a warp's slots are all in range or all out of range).
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

// Blocks of a one-thread-per-slot grid over n_slots slots.
inline cudaError_t slot_blocks(long long n_slots, unsigned* blocks) {
  const long long b = (n_slots + kThreads - 1) / kThreads;
  if (b < 1 || b > 0x7fffffffLL) return cudaErrorInvalidValue;
  *blocks = static_cast<unsigned>(b);
  return cudaSuccess;
}

// One launch of a one-thread-per-slot kernel over n_slots slots.
template <class A>
cudaError_t launch_slots(const void* kernel, A a, long long n_slots,
                         cudaStream_t stream) {
  unsigned blocks = 0;
  cudaError_t err = slot_blocks(n_slots, &blocks);
  if (err != cudaSuccess) return err;
  void* params[] = {&a};
  err = cudaLaunchKernel(kernel, dim3(blocks), dim3(kThreads), params, 0,
                         stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace sell
