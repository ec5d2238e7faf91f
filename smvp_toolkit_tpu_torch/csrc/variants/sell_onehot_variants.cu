// Variants of K6 (csrc/sell_onehot.cu), built only by
// smvp_toolkit_tpu_torch/bench/bench_variants.py (--onehot), which times
// them against the kept kernel on the same planes in one process, and by
// the checks that hold the kept kernel to the old one bit for bit
// (chip_smoke.py phase 2, tests/test_torch_cuda.py); no entry point of the
// package launches them. Each computes K6's function in K6's order, so
// each is bit-equal to it:
//   dense    (sell_onehot_dense_launch) the kernel K6 ran before: the JAX
//            launch's dense one-hot operands (xw (n_chunks, WT, 128) f32,
//            vals (S, 128) f32, lidx (S, 128) int32, oht (n_chunks,
//            chunk, WT) f32, seg (n_chunks, NS, chunk) f32), one warp per
//            output row slice streaming its seg rows and the live
//            sublanes' oht rows; S·(WT + NS)·4 bytes a launch beyond the
//            compact planes (6.18 GB on smoke's plan)
// and, through sell_onehot_variant_launch on the kept kernel's operands:
//   0 staged the walk K6 was first written with, K8's (csrc/sell_df64.cu,
//            df64_group): a block of S x 128 threads takes S slices, one
//            row a thread, stages each pass of 128 entries' sublane and x
//            tile in shared memory between two barriers, and walks them
//            with U steps' loads in flight, U in 1, 2, 4, 8 and S in 1, 2
//   1 warp   the kept body (onehot_warp: one warp per slice, four rows a
//            thread, entries staged in registers and taken by a warp
//            shuffle) with U steps in flight, U in 1, 2, 4, 8; the kept
//            kernel's is kOnehotUnroll

#include "../sell_onehot.cu"

namespace {

// ---------------------------------------------------------------------------
// dense: the kernel K6 ran before, on the dense operands
// ---------------------------------------------------------------------------

constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kLanesPerThread = kLanes / 32;  // y lanes a thread holds
constexpr int kSegLoads = 8;  // seg entries a thread loads per step

struct DenseArgs {
  const float* xw;
  const float* vals;
  const int* lidx;
  const float* oht;
  const float* seg;
  float* y;
  int n_chunks;
  int chunk;
  int wt;
  int ns;
};

// acc[j] += w · vals[s, l] · Σ_t OHT_c[s, t] · xw_c[t, lidx[s, l]] for the
// thread's lanes l = lane + 32·j of global sublane `sub` in chunk c.
__device__ __forceinline__ void add_sublane(const DenseArgs& a, long long c,
                                            long long sub, float w, int lane,
                                            float* acc) {
  const float* orow = a.oht + sub * a.wt;
  int li[kLanesPerThread];
  float v[kLanesPerThread];
  float g[kLanesPerThread];
#pragma unroll
  for (int j = 0; j < kLanesPerThread; ++j) {
    li[j] = a.lidx[sub * kLanes + lane + 32 * j];
    v[j] = a.vals[sub * kLanes + lane + 32 * j];
    g[j] = 0.0f;
  }
  for (int t0 = 0; t0 < a.wt; t0 += 32) {
    const int t = t0 + lane;
    const float o = t < a.wt ? orow[t] : 0.0f;
    unsigned hot = __ballot_sync(kFull, o != 0.0f);
    while (hot) {
      const int b = __ffs(hot) - 1;
      hot &= hot - 1;
      const float ob = __shfl_sync(kFull, o, b);
      const float* xr = a.xw + (c * a.wt + t0 + b) * kLanes;
#pragma unroll
      for (int j = 0; j < kLanesPerThread; ++j) {
        g[j] = __fadd_rn(g[j], __fmul_rn(ob, xr[li[j]]));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kLanesPerThread; ++j) {
    acc[j] = __fadd_rn(acc[j], __fmul_rn(w, __fmul_rn(v[j], g[j])));
  }
}

__global__ void __launch_bounds__(kThreads)
    sell_onehot_dense_kernel(const DenseArgs a) {
  const long long n =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (n >= a.ns) return;  // whole warps leave together
  float acc[kLanesPerThread];
#pragma unroll
  for (int j = 0; j < kLanesPerThread; ++j) acc[j] = 0.0f;
  for (long long c = 0; c < a.n_chunks; ++c) {
    const float* segrow = a.seg + (c * a.ns + n) * a.chunk;
    for (int s0 = 0; s0 < a.chunk; s0 += 32 * kSegLoads) {
      float w[kSegLoads];
#pragma unroll
      for (int q = 0; q < kSegLoads; ++q) {
        const int s = s0 + 32 * q + lane;
        w[q] = s < a.chunk ? segrow[s] : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kSegLoads; ++q) {
        unsigned todo = __ballot_sync(kFull, w[q] != 0.0f);
        while (todo) {
          const int b = __ffs(todo) - 1;
          todo &= todo - 1;
          const float wb = __shfl_sync(kFull, w[q], b);
          add_sublane(a, c, c * a.chunk + s0 + 32 * q + b, wb, lane, acc);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kLanesPerThread; ++j) {
    a.y[n * kLanes + lane + 32 * j] = acc[j];
  }
}

// ---------------------------------------------------------------------------
// staged: K8's walk, one row a thread, the entries in shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ float stream_f32(const float* p) {
  return __ldcs(p);
}
__device__ __forceinline__ float stream_f32(const __nv_bfloat16* p) {
  return __uint_as_float(static_cast<unsigned>(__ldcs(
                             reinterpret_cast<const unsigned short*>(p)))
                         << 16);
}

// U steps of one row: staged entries sub[0..U) and tile[0..U), their loads
// issued before the in-order adds.
template <int U, typename V, typename L>
__device__ __forceinline__ float staged_steps(const OnehotArgs<V, L>& a,
                                              const int* sub,
                                              const int* tile, int lane,
                                              float acc) {
  float v[U], g[U];
  int li[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long i = (static_cast<long long>(sub[u]) << 7) + lane;
    v[u] = stream_f32(a.vals + i);
    li[u] = static_cast<int>(__ldcs(a.lidx + i));
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    g[u] = gather_f32(a.x + (static_cast<long long>(tile[u]) << 7) + li[u]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) acc = __fadd_rn(acc, __fmul_rn(v[u], g[u]));
  return acc;
}

// Slice group g (slices g·Slices .. g·Slices + Slices - 1): thread t writes
// row t % 128 of slice g·Slices + t / 128.
template <int U, int Slices, typename V, typename L>
__global__ void __launch_bounds__(Slices * kLanes)
    sell_onehot_staged_kernel(const OnehotArgs<V, L> a) {
  __shared__ int s_sub[Slices * kLanes], s_tile[Slices * kLanes];
  const long long g = blockIdx.x;
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
  float acc = 0.0f;
  for (int base = 0; base < most; base += kLanes) {
    if (base + lane < count) {
      const int s = a.sublanes[first + base + lane];
      s_sub[threadIdx.x] = s;
      s_tile[threadIdx.x] = a.tile_base[s / a.chunk] + a.rel[s];
    }
    __syncthreads();
    const int m = min(kLanes, count - base);
    int j = 0;
    for (; j + U <= m; j += U) {
      acc = staged_steps<U>(a, sub + j, tile + j, lane, acc);
    }
    for (; j < m; ++j) acc = staged_steps<1>(a, sub + j, tile + j, lane, acc);
    __syncthreads();  // the next pass restages s_sub and s_tile
  }
  if (slice < n_slices) a.y[slice * kLanes + lane] = acc;
}

template <int U, int Slices, typename V, typename L>
cudaError_t launch_staged(const OnehotArgs<V, L>& a, cudaStream_t stream) {
  const long long groups = ((a.n_rows >> 7) + Slices - 1) / Slices;
  cudaError_t e = onehot_checks(a, groups);
  if (e != cudaSuccess) return e;
  sell_onehot_staged_kernel<U, Slices><<<static_cast<unsigned>(groups),
                                         Slices * kLanes, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename V, typename L>
cudaError_t staged(int u, int slices, const OnehotArgs<V, L>& a,
                   cudaStream_t st) {
#define STAGED(U, S) \
  if (u == U && slices == S) return launch_staged<U, S>(a, st);
  STAGED(1, 1) STAGED(2, 1) STAGED(4, 1) STAGED(8, 1)
  STAGED(1, 2) STAGED(2, 2) STAGED(4, 2) STAGED(8, 2)
#undef STAGED
  return cudaErrorInvalidValue;
}

template <typename V, typename L>
cudaError_t warp(int u, const OnehotArgs<V, L>& a, cudaStream_t st) {
  if (u == 1) return launch_onehot<1>(a, st);
  if (u == 2) return launch_onehot<2>(a, st);
  if (u == 4) return launch_onehot<4>(a, st);
  if (u == 8) return launch_onehot<8>(a, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// The dense kernel: y (ns·128 float32, fully written) from the dense
// operands above, as sell_onehot_launch took them before.
extern "C" int sell_onehot_dense_launch(const void* xw, const void* vals,
                                        const void* lidx, const void* oht,
                                        const void* seg, void* y,
                                        int n_chunks, int chunk, int wt,
                                        int ns, int device, void* stream) {
  if (n_chunks < 1 || chunk < 1 || wt < 1 || ns < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const DenseArgs a{static_cast<const float*>(xw),
                    static_cast<const float*>(vals),
                    static_cast<const int*>(lidx),
                    static_cast<const float*>(oht),
                    static_cast<const float*>(seg),
                    static_cast<float*>(y),
                    n_chunks,
                    chunk,
                    wt,
                    ns};
  const unsigned blocks = (static_cast<unsigned>(ns) + kWarpsPerBlock - 1) /
                          kWarpsPerBlock;
  sell_onehot_dense_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// variant 0 = staged (U = u steps in flight, `slices` slices a block),
// 1 = warp (U = u; `slices` not read); the arguments after them are
// sell_onehot_launch's.
extern "C" int sell_onehot_variant_launch(
    int variant, int u, int slices, const void* vals, const void* lidx,
    const void* rel, const void* tile_base, const void* slice_ptr,
    const void* sublanes, const void* x, void* y, long long n_rows,
    int chunk, int value_kind, int lidx_kind, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  err = with_types(value_kind, lidx_kind, [&](auto v, auto l) {
    using V = typename decltype(v)::type;
    using L = typename decltype(l)::type;
    const auto a = make_onehot_args<V, L>(vals, lidx, rel, tile_base,
                                          slice_ptr, sublanes, x, y, n_rows,
                                          chunk);
    if (variant == 0) return staged(u, slices, a, st);
    if (variant == 1) return warp(u, a, st);
    return cudaErrorInvalidValue;
  });
  return static_cast<int>(err);
}
