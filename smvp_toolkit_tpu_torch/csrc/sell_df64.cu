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
// Fixed summation order, no atomics: one thread per output row sums its
// slice's live sublanes in plan order, as the host-built index lists them
// (slice_ptr[slice] .. slice_ptr[slice + 1] into sublanes). Every product
// and sum goes through the __dmul_rn / __dadd_rn intrinsics, so the
// compiler contracts nothing into an FMA and the forward and N-iteration
// kernels give the same bits. Dead sublanes are not in the index; the lo
// plane may be absent (null), and then its terms are skipped. Every y word
// is written, so y needs no zeroing.
//
// The walk on staged slice metadata (df64_group): a block of kDf64Slices x
// 128 threads takes kDf64Slices consecutive slices, thread t row t % 128
// of slice t / 128. What a step needs beyond the row's own lane is the
// same for all 128 rows of a slice: the sublane s = sublanes[j], its
// merged word's rel and its chunk's tile_base[s / chunk]. The block stages
// it once per entry, in passes of up to 128 entries a slice: thread t
// loads entry base + t % 128 of its slice's index, decodes rel, divides
// once for the chunk and writes the sublane and the x tile (tile_base +
// rel) to shared memory. After a barrier each thread walks the staged
// entries of its slice, kDf64Unroll at a time: the values (hi, lo), the
// lane indices and then the x pairs of the kDf64Unroll steps are
// independent loads, issued together, and the terms are added to the row's
// sum strictly in order. A slice with more than 128 live sublanes takes
// several passes; one with none writes 0; the block runs as many passes
// as its longest slice needs. Before, every thread of a slice computed the
// chain sublanes[j] -> relsl[s], tile_base[s / chunk] -> the x pair itself,
// one step after another with a divide per step, so no second step's loads
// were in flight behind it: 0.096478 ms at smoke-df64 and 0.129043 ms at
// smoke-df64-f64 against float64 torch.sparse.mm's 0.086658 and 0.083549
// (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py). The N-iteration kernel
// walks the slice groups in a grid-stride loop, block-uniform since the
// staging needs __syncthreads, with one grid.sync() an iteration.
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

#include <type_traits>

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

// Slices a block takes and steps a thread has in flight, chosen on the
// H100 (bench/bench_variants.py --df64, NVIDIA H100 80GB HBM3, 700 W): of
// U = 1, 2, 4, 8 and one or two slices a block, U = 2 on one slice was the
// fastest on smoke-df64 and smoke-df64-f64 (0.052 / 0.081 ms against
// 0.064 / 0.090 for U = 4 on two slices, the first choice).
constexpr int kDf64Slices = 1;
constexpr int kDf64Unroll = 2;

// One slot's term: vh·xh + e, e = vh·xl (+ vl·xh + vl·xl), every product
// and sum rounded on its own.
template <bool Lo>
__device__ __forceinline__ double df64_term(float vh, float vl, float gh,
                                            float gl) {
  double e = __dmul_rn(vh, gl);
  if (Lo) {
    e = __dadd_rn(e, __dmul_rn(vl, gh));
    e = __dadd_rn(e, __dmul_rn(vl, gl));
  }
  return __dadd_rn(__dmul_rn(vh, gh), e);
}

// U steps of one row: staged entries sub[0..U) and tile[0..U) (x tile =
// tile_base + rel), their loads issued before the in-order adds.
template <int U, bool Lo, typename L>
__device__ __forceinline__ double df64_steps(const Df64Args<L>& a,
                                             const int* sub, const int* tile,
                                             int lane, double acc) {
  float vh[U], vl[U], gh[U], gl[U];
  int li[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long i = (static_cast<long long>(sub[u]) << 7) + lane;
    vh[u] = __ldcs(a.vals_hi + i);
    vl[u] = Lo ? __ldcs(a.vals_lo + i) : 0.0f;
    li[u] = static_cast<int>(__ldcs(a.lidx + i));
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long col = (static_cast<long long>(tile[u]) << 7) + li[u];
    gh[u] = __ldg(a.x_hi + col);
    gl[u] = __ldg(a.x_lo + col);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    acc = __dadd_rn(acc, df64_term<Lo>(vh[u], vl[u], gh[u], gl[u]));
  }
  return acc;
}

// Slice group g (slices g·Slices .. g·Slices + Slices - 1): every thread of
// the block calls it with the same g; thread t writes row t % 128 of slice
// g·Slices + t / 128. s_sub and s_tile hold Slices·128 ints each.
template <int U, int Slices, bool Lo, typename L>
__device__ __forceinline__ void df64_group(const Df64Args<L>& a,
                                           long long g, int* s_sub,
                                           int* s_tile) {
  const long long n_slices = a.n_rows >> 7;
  const int h = threadIdx.x >> 7;
  const int lane = threadIdx.x & (kLanes - 1);
  const long long slice = g * Slices + h;
  int first = 0, count = 0, most = 0;
#pragma unroll
  for (int k = 0; k < Slices; ++k) {
    const long long sk = g * Slices + k;
    if (sk < n_slices) {
      const int b = a.slice_ptr[sk];
      const int n = a.slice_ptr[sk + 1] - b;
      most = max(most, n);
      if (k == h) {
        first = b;
        count = n;
      }
    }
  }
  const int* sub = s_sub + h * kLanes;
  const int* tile = s_tile + h * kLanes;
  double acc = 0.0;
  for (int base = 0; base < most; base += kLanes) {
    if (base + lane < count) {
      const int s = a.sublanes[first + base + lane];  // S < 2^31
      const int rel = static_cast<int>(static_cast<unsigned>(a.relsl[s]) &
                                       kRelDead);  // live by the index
      s_sub[threadIdx.x] = s;
      s_tile[threadIdx.x] = a.tile_base[s / a.chunk] + rel;
    }
    __syncthreads();
    const int m = min(kLanes, count - base);
    int j = 0;
    for (; j + U <= m; j += U) {
      acc = df64_steps<U, Lo>(a, sub + j, tile + j, lane, acc);
    }
    for (; j < m; ++j) {
      acc = df64_steps<1, Lo>(a, sub + j, tile + j, lane, acc);
    }
    __syncthreads();  // the next pass restages s_sub and s_tile
  }
  if (slice < n_slices) {
    const long long t = slice * kLanes + lane;
    const float hi = __double2float_rn(acc);
    a.y_hi[t] = hi;
    a.y_lo[t] = __double2float_rn(__dsub_rn(acc, static_cast<double>(hi)));
  }
}

template <int U, int Slices, bool Lo, typename L>
__global__ void __launch_bounds__(Slices * kLanes)
    sell_df64_kernel(const Df64Args<L> a) {
  __shared__ int s_sub[Slices * kLanes], s_tile[Slices * kLanes];
  df64_group<U, Slices, Lo>(a, blockIdx.x, s_sub, s_tile);
}

template <int U, int Slices, bool Lo, typename L>
__global__ void __launch_bounds__(Slices * kLanes)
    sell_bench_df64_kernel(const Df64Args<L> a) {
  __shared__ int s_sub[Slices * kLanes], s_tile[Slices * kLanes];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const long long groups = ((a.n_rows >> 7) + Slices - 1) / Slices;
  for (int it = 0; it < a.iterations; ++it) {
    for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
      df64_group<U, Slices, Lo>(a, g, s_sub, s_tile);
    }
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

// Calls fn(Tag<L>, Lo) for lidx_kind 0 = int8, 1 = int32 and Lo =
// std::bool_constant<lo> (lo: a vals_lo plane is given).
template <typename Fn>
cudaError_t with_kinds(int lidx_kind, bool lo, Fn&& fn) {
  const auto go = [&](auto l) {
    return lo ? fn(l, std::true_type{}) : fn(l, std::false_type{});
  };
  if (lidx_kind == 0) return go(Tag<int8_t>{});
  if (lidx_kind == 1) return go(Tag<int32_t>{});
  return cudaErrorInvalidValue;
}

// One block of Slices·128 threads per group of Slices slices.
template <int U, int Slices, bool Lo, typename L>
cudaError_t launch_df64(Df64Args<L> a, cudaStream_t stream) {
  const long long groups = ((a.n_rows >> 7) + Slices - 1) / Slices;
  if (a.n_rows < 1 || a.n_rows % kLanes || groups > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  void* params[] = {&a};
  cudaError_t e = cudaLaunchKernel(
      reinterpret_cast<const void*>(sell_df64_kernel<U, Slices, Lo, L>),
      dim3(static_cast<unsigned>(groups)), dim3(Slices * kLanes), params, 0,
      stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The N-iteration kernel: a cooperative grid of co-resident blocks.
template <int U, int Slices, bool Lo, typename L>
cudaError_t launch_bench_df64(Df64Args<L> a, int device,
                              cudaStream_t stream) {
  if (a.n_rows < 1 || a.n_rows % kLanes || a.iterations < 1) {
    return cudaErrorInvalidValue;
  }
  const auto kernel = sell_bench_df64_kernel<U, Slices, Lo, L>;
  int blocks = 0;
  cudaError_t e = cooperative_grid(kernel, device, &blocks, Slices * kLanes);
  if (e != cudaSuccess) return e;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(blocks), dim3(Slices * kLanes),
                                  params, 0, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
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
  err = with_kinds(lidx_kind, vals_lo != nullptr, [&](auto l, auto lo) {
    using L = typename decltype(l)::type;
    return launch_df64<kDf64Unroll, kDf64Slices, decltype(lo)::value>(
        make_df64_args<L>(vals_hi, vals_lo, lidx, relsl, tile_base,
                          slice_ptr, sublanes, x_hi, x_lo, y_hi, y_lo,
                          n_rows, chunk, 0),
        static_cast<cudaStream_t>(stream));
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
  err = with_kinds(lidx_kind, vals_lo != nullptr, [&](auto l, auto lo) {
    using L = typename decltype(l)::type;
    return launch_bench_df64<kDf64Unroll, kDf64Slices, decltype(lo)::value>(
        make_df64_args<L>(vals_hi, vals_lo, lidx, relsl, tile_base,
                          slice_ptr, sublanes, x_hi, x_lo, y_hi, y_lo,
                          n_rows, chunk, iterations),
        device, static_cast<cudaStream_t>(stream));
  });
  return static_cast<int>(err);
}

// Blocks of one sell_bench_df64_kernel launch on this device (the
// instance without a lo plane).
extern "C" int sell_bench_df64_blocks(int lidx_kind, int device,
                                      int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      with_kinds(lidx_kind, false, [&](auto l, auto lo) {
        using L = typename decltype(l)::type;
        return cooperative_grid(
            sell_bench_df64_kernel<kDf64Unroll, kDf64Slices,
                                   decltype(lo)::value, L>,
            device, blocks, kDf64Slices * kLanes);
      }));
}
