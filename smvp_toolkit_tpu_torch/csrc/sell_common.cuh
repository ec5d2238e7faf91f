// One slot of the SELL-T1 SpMV, shared by every forward and bench kernel
// (csrc/sell_spmv.cu, csrc/sell_bench.cu).
//
// Per live slot (s, l) of the (S, 128) planes, with c = s / chunk:
//   y[(ybase(c) + slice(s)) * 128 + l] +=
//       vals[s, l] * x[(tile_base[c] + rel(s)) * 128 + lidx[s, l]]
// Two policies pick the kernel's route:
//   * how a sublane's rel and slice are decoded: the merged rel‖slice word
//     (rel in bits 0..8, 511 = dead; slice in bits 9..31, all ones = dead),
//     or the split rel_tile and slice_of planes (int32 each, -1 = dead);
//   * how y is addressed: resident (ybase = 0) or block-streamed
//     (ybase = y_block_id[c] * nsb, slice ids local to the block).
// A sublane is dead when rel OR slice is dead: the planner gives dead
// padding sublanes the last real tile, so their rel is live and only the
// slice marks them.
//
// One thread per slot: 128 consecutive threads cover one sublane, so the
// vals/lidx loads are coalesced and the sublane's metadata is one
// broadcast load. The x value is gathered directly and the product lands
// in y with a float atomicAdd (summation order varies from run to run:
// compare y with a tolerance, never bitwise). Zero products (padding
// slots) skip the atomic; NaN and Inf products still land. Values are f32
// or bf16 storage, products and sums f32. Tile, column, slot and row
// indices are 64-bit: a window may span the whole column range (rel then
// needs the full int32) and plans of 180M slots occur.

#pragma once

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
  const int* meta;        // merged rel‖slice word, or rel_tile (split)
  const int* slice;       // slice_of (split routes only)
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

struct MergedWord {
  template <class A>
  __device__ __forceinline__ static bool decode(const A& a, long long s,
                                                long long* rel,
                                                long long* slice) {
    const unsigned word = static_cast<unsigned>(a.meta[s]);
    const unsigned r = word & kRelDead;
    const unsigned sl = word >> kSliceShift;
    if (r == kRelDead || sl == kSliceDead) return false;
    *rel = r;
    *slice = sl;
    return true;
  }
};

struct SplitPlanes {
  template <class A>
  __device__ __forceinline__ static bool decode(const A& a, long long s,
                                                long long* rel,
                                                long long* slice) {
    const int r = a.meta[s];
    const int sl = a.slice[s];
    if (r < 0 || sl < 0) return false;
    *rel = r;
    *slice = sl;
    return true;
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
  const long long s = i >> 7;
  const long long lane = i & (kLanes - 1);
  long long rel, slice;
  if (!Decode::decode(a, s, &rel, &slice)) return;
  const long long c = s / a.chunk;
  const long long col =
      (static_cast<long long>(a.tile_base[c]) + rel) * kLanes +
      static_cast<long long>(a.lidx[i]);
  const float p = to_f32(a.vals[i]) * to_f32(a.x[col]);
  if (p != 0.0f) {
    atomicAdd(a.y + (YAddr::base(a, c) + slice) * kLanes + lane, p);
  }
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
