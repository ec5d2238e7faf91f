// SELL-T1 SpMV for Hopper (sm_90a) on the plan's own planes, rows walked
// by slice in a fixed order (K6, the SMVP_SELL_COMPAT=1 kernel).
//
// Replaces _make_sell_kernel_onehot of the JAX package's ops/spmv_pallas.py
// (launched at :1369 under SMVP_SELL_COMPAT=1, resident y, k = 1). That
// kernel takes dense one-hot operands that XLA builds outside it
// (:1333-1363), so that Mosaic compiles it with no iota-compare, dynamic
// slice or sub-word type; per chunk c
//   table = OHT_c · xw_c,  g[s, l] = table[s, lidx[s, l]],
//   y += SEG_c · (vals ∘ g),
// with OHT_c[s, t] = (rel[s] == t) and SEG_c[n, s] = (slice_of[s] == n).
// Its function on the compact planes is
//   y[slice_of[s]·128 + l] += vals[s, l] · x[(tile_base[s / chunk] +
//                                            rel[s])·128 + lidx[s, l]]
// over the sublanes whose rel and slice are live, summed chunk by chunk and
// sublane by sublane. The card gathers and needs no one-hot operand, so
// this kernel reads the plan's planes in their storage types (values f32 or
// bf16, lane indices int8 or int32, the split rel plane), tile_base, x and
// the slice index, and no dense operand at all.
//
// Fixed summation order, no atomics, as K8 (csrc/sell_df64.cu): each output
// row is summed by one thread over its slice's live sublanes in plan order,
// as the host-built index lists them (slice_ptr[slice] .. slice_ptr[slice + 1]
// into sublanes; spmv_sell.device_slice_index): acc = acc + v·x with each
// product and sum rounded on its own (__fmul_rn, __fadd_rn, so nothing is
// contracted into an FMA). Plan order within a slice is (chunk, sublane)
// order, the order in which the dense-operand kernel this one replaces
// (csrc/variants/sell_onehot_variants.cu, dense) summed; that kernel's
// g = 0 + 1·x and acc + 1·(v·g) round exactly like acc + v·x, so the two
// give the same bits. Every lane of a live sublane is multiplied, padding
// lanes too: an Inf at a padding lane's column gives NaN, the k = 1
// contract. Sublanes whose rel or slice is dead are not in the index; they
// added nothing before either (a zero oht row or seg column). Every y word
// is written once, so y needs no zeroing.
//
// The walk (onehot_warp): one warp per slice, thread q holding rows
// 4q .. 4q + 3 of it. What a step needs beyond a thread's own lanes is the
// same for all 128 rows of the slice: the sublane s and its x tile
// tile_base[s / chunk] + rel[s]. The warp stages them in passes of 32
// entries, one entry a thread, in registers; every step takes its entry
// from the thread that loaded it by a warp shuffle, so no shared memory
// and no block barrier is needed. A step's values and lane indices are one
// 16-byte (bf16: 8-byte) load and one 4-byte (int32: 16-byte) load a
// thread, and the thread gathers its four x words; kOnehotUnroll steps'
// loads are issued together before their products are added, strictly in
// order, to the four rows' sums. A slice with more than 32 live sublanes
// takes several passes, one with none writes 0. A hub slice (a row of many
// products) is walked by one warp from end to end: the order is what the
// bits depend on.
//
// Chosen on the H100 (bench/bench_variants.py --onehot; NVIDIA H100 80GB
// HBM3, 700 W): first written as K8's walk, a block of 128 threads a slice
// staging its entries in shared memory, one row a thread, two steps in
// flight; this body at four steps took 0.897 / 0.692x its time on smoke
// (f32 / bf16) and 0.879 / 0.698x on L2, and no staged form (U = 1, 2, 4,
// 8, one or two slices a block) came within 5% of it in bf16. Both are
// kept in csrc/variants/sell_onehot_variants.cu, with the dense-operand
// kernel.
//
// Bound on this card: bytes. Each launch reads the values and lane planes
// of the live sublanes, rel and the index once per live sublane, tile_base,
// x and writes y: 130.0 MB (f32) or 79.8 MB (bf16) on smoke's plan, where
// the dense operands were 6.18 GB. The work is 2 flops per slot.
//
// C interface (ctypes): the launch returns a cudaError_t value, 0 on
// success, from cudaGetLastError() right after the launch; the stream is
// PyTorch's current stream; nothing here allocates or synchronises. A
// values or lane-index plane not aligned to four elements returns
// cudaErrorMisalignedAddress and launches nothing, as the warp-per-sublane
// kernels do; no plane is copied and nothing falls back.

#include "sell_common.cuh"

namespace {

using namespace sell;

template <typename V, typename L>
struct OnehotArgs {
  const V* vals;          // (S, 128)
  const L* lidx;          // (S, 128)
  const int* rel;         // per sublane: tile - tile_base[chunk]
  const int* tile_base;   // per chunk
  const int* slice_ptr;   // n_slices + 1 offsets into sublanes
  const int* sublanes;    // live sublanes, by slice, in plan order
  const V* x;             // CT * 128
  float* y;               // n_rows
  long long n_rows;       // n_slices * 128
  int chunk;
};

// Steps a thread has in flight.
constexpr int kOnehotUnroll = 4;

// A gathered x word as float32: bf16 bits are the high half of the
// float32 with the same value.
__device__ __forceinline__ float gather_f32(const float* p) {
  return __ldg(p);
}
__device__ __forceinline__ float gather_f32(const __nv_bfloat16* p) {
  return __uint_as_float(
      static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p)))
      << 16);
}

// U steps j .. j + U - 1 of the warp's pass: each entry's sublane and tile
// from the thread that staged it, then the loads of all U steps, then the
// adds in order.
template <int U, typename V, typename L>
__device__ __forceinline__ void onehot_steps(const OnehotArgs<V, L>& a,
                                             int my_s, int my_t, int j,
                                             int q, float (&acc)[4]) {
  float v[U][4], g[U][4];
  int li[U][4], t[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int s = __shfl_sync(kFull, my_s, j + u);
    t[u] = __shfl_sync(kFull, my_t, j + u);
    const long long p = (static_cast<long long>(s) << 7) + 4 * q;
    load_values<Streaming>(a.vals + p, v[u]);
    load_lanes<Streaming>(a.lidx + p, li[u]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const V* xt = a.x + (static_cast<long long>(t[u]) << 7);
#pragma unroll
    for (int i = 0; i < 4; ++i) g[u][i] = gather_f32(xt + li[u][i]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i] = __fadd_rn(acc[i], __fmul_rn(v[u][i], g[u][i]));
    }
  }
}

// The warp of `slice` (every thread of the warp calls it with the same
// slice): thread q writes rows 4q .. 4q + 3.
template <int U, typename V, typename L>
__device__ __forceinline__ void onehot_warp(const OnehotArgs<V, L>& a,
                                            long long slice, int q) {
  const int first = a.slice_ptr[slice];
  const int count = a.slice_ptr[slice + 1] - first;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int base = 0; base < count; base += 32) {
    int my_s = 0, my_t = 0;
    if (base + q < count) {
      my_s = a.sublanes[first + base + q];  // S < 2^31
      my_t = a.tile_base[my_s / a.chunk] + a.rel[my_s];
    }
    const int m = min(32, count - base);
    int j = 0;
    for (; j + U <= m; j += U) onehot_steps<U>(a, my_s, my_t, j, q, acc);
    for (; j < m; ++j) onehot_steps<1>(a, my_s, my_t, j, q, acc);
  }
  reinterpret_cast<float4*>(a.y + slice * kLanes)[q] =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
}

template <int U, typename V, typename L>
__global__ void __launch_bounds__(kThreads)
    sell_onehot_kernel(const OnehotArgs<V, L> a) {
  const long long slice =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (slice >= (a.n_rows >> 7)) return;  // whole warps leave together
  onehot_warp<U>(a, slice, threadIdx.x & 31);
}

template <typename V, typename L>
OnehotArgs<V, L> make_onehot_args(const void* vals, const void* lidx,
                                  const void* rel, const void* tile_base,
                                  const void* slice_ptr,
                                  const void* sublanes, const void* x,
                                  void* y, long long n_rows, int chunk) {
  return OnehotArgs<V, L>{static_cast<const V*>(vals),
                          static_cast<const L*>(lidx),
                          static_cast<const int*>(rel),
                          static_cast<const int*>(tile_base),
                          static_cast<const int*>(slice_ptr),
                          static_cast<const int*>(sublanes),
                          static_cast<const V*>(x),
                          static_cast<float*>(y),
                          n_rows,
                          chunk};
}

// The vector loads and stores: values and lane indices aligned to four
// elements, as sublane_aligned asks of the warp-per-sublane kernels'
// planes, and y to 16 bytes.
template <typename V, typename L>
bool onehot_aligned(const OnehotArgs<V, L>& a) {
  const auto at = [](const void* p, size_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  return at(a.vals, 4 * sizeof(V)) && at(a.lidx, 4 * sizeof(L)) &&
         at(a.y, 16);
}

// What every form of the walk refuses before it launches: rows that are
// not whole slices, a grid too large, misaligned planes.
template <typename V, typename L>
cudaError_t onehot_checks(const OnehotArgs<V, L>& a, long long blocks) {
  if (a.n_rows < 1 || a.n_rows % kLanes || a.chunk < 1 ||
      blocks > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  if (!onehot_aligned(a)) return cudaErrorMisalignedAddress;
  return cudaSuccess;
}

// One warp per slice, kThreads / 32 slices a block.
template <int U, typename V, typename L>
cudaError_t launch_onehot(const OnehotArgs<V, L>& a, cudaStream_t stream) {
  constexpr long long kSlicesPerBlock = kThreads / 32;
  const long long blocks =
      ((a.n_rows >> 7) + kSlicesPerBlock - 1) / kSlicesPerBlock;
  cudaError_t e = onehot_checks(a, blocks);
  if (e != cudaSuccess) return e;
  sell_onehot_kernel<U><<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// y (n_rows = n_slices * 128 float32, fully written) from the planes and
// the slice index. value_kind 0 = float32, 1 = bfloat16 (vals and x);
// lidx_kind 0 = int8, 1 = int32.
extern "C" int sell_onehot_launch(const void* vals, const void* lidx,
                                  const void* rel, const void* tile_base,
                                  const void* slice_ptr,
                                  const void* sublanes, const void* x,
                                  void* y, long long n_rows, int chunk,
                                  int value_kind, int lidx_kind, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = with_types(value_kind, lidx_kind, [&](auto v, auto l) {
    using V = typename decltype(v)::type;
    using L = typename decltype(l)::type;
    return launch_onehot<kOnehotUnroll>(
        make_onehot_args<V, L>(vals, lidx, rel, tile_base, slice_ptr,
                               sublanes, x, y, n_rows, chunk),
        static_cast<cudaStream_t>(stream));
  });
  return static_cast<int>(err);
}
