// Variants of the N-iteration body of csrc/sell_bench.cu, built only by
// smvp_toolkit_tpu_torch/bench/bench_variants.py, which times them against
// the kept kernels on the same planes in one process; no entry point of
// the package launches them. Each is the warp-per-sublane body of
// sell_common.cuh on one of the four routes (sell::Route), int8 lane
// indices, with one thing changed:
//   0 barrier1  one barrier an iteration, two y buffers in turn, streaming
//               plane loads (sublane_bench_sweeps<Stage, YAddr, 2>: K2's
//               form)
//   1 barrier2  two barriers an iteration around the zeroing of one y
//               (<Stage, YAddr, 1>: the other three routes' form)
//   2 cached    as 0, the plane loads through the read-only path, L1 and
//               L2 allocating (__ldg)
//   3 nol1      as 0, the plane loads kept out of L1 only
//               (ld.global.nc.L1::no_allocate, L2's normal policy)
//   4 dynamic   as 0, the blocks taking work items from an atomic counter
//               per iteration (two counters in turn) instead of the static
//               grid-stride walk
//   5 slot      the one-thread-per-slot body (bench_sweeps over slot) that
//               K2 and K2 streamed ran before; merged-word routes only
// Variants 1 and 5 leave the result in y[0]; the others in y[(N - 1) % 2].
//
// K2-subwin's forms (sell_bench_subwin_variant_launch, int8 lane indices):
// the warp-per-sublane body under SubwinWord with one y buffer and two
// barriers an iteration (form 1) or two buffers and one barrier (form 2,
// the kept kernel's), and the one-thread-per-slot walk it ran before (form
// 0: a 64-bit divide, the window loads and the word's decoding per slot, a
// scalar atomic, two barriers). Forms 0 and 1 leave the result in y[0],
// form 2 in y[(N - 1) % 2].

#include "../sell_common.cuh"
#include "slot_walks.cuh"

namespace {

using namespace sell;

struct NoL1 {
  __device__ __forceinline__ static float4 load(const float4* p) {
    float4 r;
    asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
        : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
        : "l"(p));
    return r;
  }
  __device__ __forceinline__ static uint2 load(const uint2* p) {
    uint2 r;
    asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
        : "=r"(r.x), "=r"(r.y)
        : "l"(p));
    return r;
  }
  __device__ __forceinline__ static int load(const int* p) {
    int r;
    asm("ld.global.nc.L1::no_allocate.s32 %0, [%1];" : "=r"(r) : "l"(p));
    return r;
  }
  __device__ __forceinline__ static int4 load(const int4* p) {
    int4 r;
    asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
        : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
        : "l"(p));
    return r;
  }
};

template <typename V, typename L>
struct VArgs {
  Args<V, L> a;
  int* counters;  // two ints, variant 4 only
};

template <class Stage, class YAddr, typename V, typename L>
__device__ __forceinline__ void dynamic_sweeps(const Args<V, L>& a,
                                               int* counters) {
  __shared__ int s_rel[kRun], s_slice[kRun];
  __shared__ int s_item;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int runs = runs_per_chunk(a.chunk);
  const long long chunk_slots = static_cast<long long>(kLanes) * a.chunk;
  const int items = static_cast<int>(a.n_slots / chunk_slots) * runs;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long n4 = a.n_out / 4;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4* y4 = reinterpret_cast<float4*>(a.y);
  for (long long i = tid; i < n4; i += stride) y4[i] = zero;
  if (tid == 0) counters[0] = 0;
  grid.sync();
  for (int it = 0; it < a.iterations; ++it) {
    const bool more = it + 1 < a.iterations;
    if (more) {
      float4* next = y4 + ((it + 1) & 1) * n4;
      for (long long i = tid; i < n4; i += stride) next[i] = zero;
      if (tid == 0) counters[(it + 1) & 1] = 0;
    }
    float* out = a.y + (it & 1) * a.n_out;
    for (;;) {
      if (threadIdx.x == 0) s_item = atomicAdd(&counters[it & 1], 1);
      __syncthreads();
      const int item = s_item;
      if (item >= items) break;
      sublane_run<Stage, YAddr>(a, out, runs, item, s_rel, s_slice);
    }
    if (more) grid.sync();
  }
}

template <int Variant, class Stage, class YAddr, typename V, typename L>
__global__ void __launch_bounds__(kThreads, kSublaneMinBlocks)
    variant_kernel(const VArgs<V, L> w) {
  if constexpr (Variant == 0) {
    sublane_bench_sweeps<Stage, YAddr, 2>(w.a);
  } else if constexpr (Variant == 1) {
    sublane_bench_sweeps<Stage, YAddr, 1>(w.a);
  } else if constexpr (Variant == 2) {
    sublane_bench_sweeps<Stage, YAddr, 2, ReadOnly>(w.a);
  } else if constexpr (Variant == 3) {
    sublane_bench_sweeps<Stage, YAddr, 2, NoL1>(w.a);
  } else {
    dynamic_sweeps<Stage, YAddr>(w.a, w.counters);
  }
}

template <class YAddr, typename V, typename L>
__global__ void __launch_bounds__(kThreads)
    slot_kernel(const VArgs<V, L> w) {
  bench_sweeps<MergedWord, YAddr>(w.a);
}

template <typename V, typename L>
using VKernel = void (*)(VArgs<V, L>);

template <int Variant, typename V, typename L>
VKernel<V, L> on_route(int route) {
  switch (route) {
    case kRelsl: return variant_kernel<Variant, MergedWord, ResidentY, V, L>;
    case kStreamyRelsl:
      return variant_kernel<Variant, MergedWord, StreamedY, V, L>;
    case kStreamy:
      return variant_kernel<Variant, SplitPlanes, StreamedY, V, L>;
    case kSplit: return variant_kernel<Variant, SplitPlanes, ResidentY, V, L>;
    default: return nullptr;
  }
}

template <typename V, typename L>
VKernel<V, L> variant_of(int variant, int route) {
  switch (variant) {
    case 0: return on_route<0, V, L>(route);
    case 1: return on_route<1, V, L>(route);
    case 2: return on_route<2, V, L>(route);
    case 3: return on_route<3, V, L>(route);
    case 4: return on_route<4, V, L>(route);
    case 5:
      if (route == kRelsl) return slot_kernel<ResidentY, V, L>;
      if (route == kStreamyRelsl) return slot_kernel<StreamedY, V, L>;
      return nullptr;
    default: return nullptr;
  }
}

template <typename V>
cudaError_t launch_variant(int variant, int route, VArgs<V, int8_t> w,
                           int device, cudaStream_t stream) {
  const Args<V, int8_t>& a = w.a;
  const bool split = route == kStreamy || route == kSplit;
  const bool streamed = route == kStreamyRelsl || route == kStreamy;
  if ((split && a.slice == nullptr) ||
      (streamed && (a.y_block_id == nullptr || a.nsb < 1)) ||
      a.iterations < 1 || (variant == 4 && w.counters == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (!sublane_aligned(a)) return cudaErrorMisalignedAddress;
  long long items = 0;
  if (!sublane_items(a, &items) || a.n_out % 4) return cudaErrorInvalidValue;
  VKernel<V, int8_t> kernel = variant_of<V, int8_t>(variant, route);
  int blocks = 0;
  cudaError_t err = cooperative_grid(kernel, device, &blocks);
  if (err != cudaSuccess) return err;
  void* params[] = {&w};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(blocks), dim3(kThreads), params, 0,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// K2-subwin's old walk: slot i of a one-thread-per-slot grid.
template <typename V, typename L>
__device__ __forceinline__ void subwin_slot(const SubwinArgs<V, L>& a,
                                            long long i) {
  const long long s = i >> 7;
  const long long c = s / a.chunk;
  const long long h = (s - c * a.chunk) / (a.chunk / a.split);
  const long long stb = a.stb[c * a.split + h];
  const long long ssb = a.ssb[c * a.split + h];
  const unsigned word = static_cast<unsigned>(a.meta[s]);
  const long long rel_adj = static_cast<long long>(word & kRelDead) -
                            (stb - static_cast<long long>(a.tile_base[c]));
  const long long slice = word >> kSliceShift;
  if (rel_adj < 0 || rel_adj >= a.sub_wt || slice < ssb ||
      slice >= ssb + a.sub_nsw) {
    return;
  }
  const long long col =
      (stb + rel_adj) * kLanes + static_cast<long long>(a.lidx[i]);
  const float p = to_f32(a.vals[i]) * to_f32(a.x[col]);
  if (p != 0.0f) atomicAdd(a.y + slice * kLanes + (i & (kLanes - 1)), p);
}

// Form 0, built as it was (__launch_bounds__(kThreads)).
template <typename V, typename L>
__global__ void __launch_bounds__(kThreads)
    subwin_walk_kernel(const SubwinArgs<V, L> a) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (int it = 0; it < a.iterations; ++it) {
    for (long long i = tid; i < a.n_out; i += stride) a.y[i] = 0.0f;
    grid.sync();
    for (long long i = tid; i < a.n_slots; i += stride) subwin_slot(a, i);
    grid.sync();
  }
}

// Forms 1 and 2: y buffers.
template <int YBuffers, typename V, typename L>
__global__ void __launch_bounds__(kThreads, kSublaneMinBlocks)
    subwin_form_kernel(const SubwinArgs<V, L> a) {
  sublane_bench_sweeps<SubwinWord, ResidentY, YBuffers>(a);
}

template <typename V>
cudaError_t launch_subwin_form(int form, SubwinArgs<V, int8_t> a, int device,
                               cudaStream_t stream) {
  if (a.split < 2 || a.chunk % a.split || a.sub_wt < 1 || a.sub_nsw < 1 ||
      a.iterations < 1 || a.stb == nullptr || a.ssb == nullptr) {
    return cudaErrorInvalidValue;
  }
  if (!sublane_aligned(a)) return cudaErrorMisalignedAddress;
  long long items = 0;
  if (!sublane_items(a, &items) || a.n_out % 4) return cudaErrorInvalidValue;
  void (*kernel)(SubwinArgs<V, int8_t>) = nullptr;
  if (form == 0) kernel = subwin_walk_kernel<V, int8_t>;
  if (form == 1) kernel = subwin_form_kernel<1, V, int8_t>;
  if (form == 2) kernel = subwin_form_kernel<2, V, int8_t>;
  int blocks = 0;
  cudaError_t err = cooperative_grid(kernel, device, &blocks);
  if (err != cudaSuccess) return err;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(blocks), dim3(kThreads), params, 0,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// K2-subwin in one of its forms (0, 1, 2 above): arguments as
// sell_bench_subwin_launch (int8 lane indices only), after the form; y
// holds 2 * n_out floats.
extern "C" int sell_bench_subwin_variant_launch(
    int form, const void* vals, const void* lidx, const void* relsl,
    const void* tile_base, const void* stb, const void* ssb, const void* x,
    void* y, long long n_slots, long long n_out, int chunk, int split,
    int sub_wt, int sub_nsw, int iterations, int value_kind, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto tag) {
    using V = typename decltype(tag)::type;
    SubwinArgs<V, int8_t> a{
        sell::make_args<V, int8_t>(vals, lidx, relsl, nullptr, tile_base,
                                   nullptr, x, y, n_slots, n_out, chunk, 0,
                                   iterations),
        static_cast<const int*>(stb), static_cast<const int*>(ssb), split,
        sub_wt, sub_nsw};
    return launch_subwin_form<V>(form, a, device, st);
  };
  if (value_kind == 0) err = go(sell::Tag<float>{});
  else if (value_kind == 1) err = go(sell::Tag<__nv_bfloat16>{});
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// Arguments as sell_bench_launch (int8 lane indices only), plus the
// variant and, for variant 4, two int32 counters; y holds 2 * n_out floats.
extern "C" int sell_bench_variant_launch(
    int variant, int route, const void* vals, const void* lidx,
    const void* meta, const void* slice, const void* tile_base,
    const void* y_block_id, const void* x, void* y, void* counters,
    long long n_slots, long long n_out, int chunk, int nsb, int iterations,
    int value_kind, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto tag) {
    using V = typename decltype(tag)::type;
    VArgs<V, int8_t> w{
        sell::make_args<V, int8_t>(vals, lidx, meta, slice, tile_base,
                                   y_block_id, x, y, n_slots, n_out, chunk,
                                   nsb, iterations),
        static_cast<int*>(counters)};
    return launch_variant<V>(variant, route, w, device, st);
  };
  if (value_kind == 0) err = go(sell::Tag<float>{});
  else if (value_kind == 1) err = go(sell::Tag<__nv_bfloat16>{});
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// Blocks of one launch of a variant (SMs x co-resident blocks).
extern "C" int sell_bench_variant_blocks(int variant, int route,
                                         int value_kind, int device,
                                         int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (value_kind == 0) {
    err = cooperative_grid(variant_of<float, int8_t>(variant, route), device,
                           blocks);
  } else {
    err = cooperative_grid(variant_of<__nv_bfloat16, int8_t>(variant, route),
                           device, blocks);
  }
  return static_cast<int>(err);
}
