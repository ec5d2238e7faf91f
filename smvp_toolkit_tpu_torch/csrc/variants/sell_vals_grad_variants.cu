// Variants of the values-gradient kernel K7 (csrc/sell_vals_grad.cu), built
// only by smvp_toolkit_tpu_torch/bench/bench_variants.py (--vgrad), which
// times them against the kept kernel and torch.sparse.sampled_addmm on the
// same planes in one process; no entry point of the package launches them.
// Each computes K7's function on the merged word or the split planes:
//   0 walk     the one-thread-per-slot walk K7 ran before: a warp per 32
//              slots of a sublane, each slot's X row and G row broadcast
//              with __shfl_sync, the lanes over k, a five-step butterfly a
//              slot (a G row and an X row read per slot)
//   1 run      per run, on sublane_mat_run's staging: a block per work
//              item of 64 sublanes of one chunk (plan order), its runs of
//              one slice's sublanes (cut at kMatRunCap, 16), and a unit
//              per (run, lane) for all 128 lanes: eight threads hold the
//              lane's G row (a column block of 8·W columns) and walk the
//              run's sublanes, one gathered X row each (G read once per
//              run, not once per slot)
//   2 nostage  the kept by-slice body (the same schedule) with step 3's G
//              columns loaded from G itself, not from the block's copy in
//              shared memory (StageG false)
//   3 block    the by-slice body as first written: step 2 per column
//              block, inside step 3's loop, each group taking four lanes of
//              index != 0 at once (one 16-byte load of each), against the
//              block's copy of G
//   4 rows8    the kept body with eight column blocks a load round in step
//              2 instead of four (RowBlocks 8)
//   5 lanes    the kept body with step 2 walking the lanes, a warp per lane:
//              the lane's G columns (a chunk of 64·W) held in registers,
//              its four groups taking the lane's masked sublanes in turn,
//              each gathering that X row's chunk
// The by-slice schedule's unit cap is a wrapper argument, so caps below
// kVgRun are timed on the kept kernel itself (a schedule built with that
// cap), not here.

#include "../sell_vals_grad.cu"

namespace {

using namespace sell;

template <class Decode, typename V, typename L>
__global__ void __launch_bounds__(kThreads)
    walk_kernel(const MatArgs<V, L> a) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if ((i & ~31LL) >= a.n_slots) return;  // whole warps only
  const int lane = threadIdx.x & 31;
  long long col = 0, row = 0;
  float mine = 0.0f;
  if (slot_coords<Decode>(a, i, &col, &row)) {  // uniform over the warp
    const long long k = a.k;
    for (int t = 0; t < 32; ++t) {
      const V* xr = a.x + __shfl_sync(kFull, col, t) * k;
      const float* gr = a.g + __shfl_sync(kFull, row, t) * k;
      float acc = 0.0f;
      for (long long j = lane; j < k; j += 32) {
        acc += gr[j] * to_f32(xr[j]);
      }
      for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(kFull, acc, off);
      }
      if (lane == t) mine = acc;
    }
  }
  a.out[i] = mine;
}

// The per-run form: a block per work item.
template <class Decode, int W, typename V, typename L>
__global__ void __launch_bounds__(kThreads)
    run_kernel(const MatArgs<V, L> a) {
  constexpr int kCols = 8 * W;
  __shared__ int key[kRun];        // slice, -1 where dead
  __shared__ long long xrow[kRun]; // first X row of the sublane's tile
  __shared__ int heads[kRun];      // the item's run heads, in order
  __shared__ int n_heads;
  const int runs = runs_per_chunk(a.chunk);
  const int item = blockIdx.x;
  const int c = item / runs;
  const int first = (item - c * runs) * kRun;
  const int n = min(kRun, a.chunk - first);
  const long long s0 = static_cast<long long>(c) * a.chunk + first;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < n) {
    long long rel = 0, sl = 0;
    const bool live = Decode::decode(a, (s0 + threadIdx.x) * kLanes, &rel,
                                     &sl);
    key[threadIdx.x] = live ? static_cast<int>(sl) : -1;
    xrow[threadIdx.x] = (static_cast<long long>(a.tile_base[c]) + rel) * kLanes;
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // warp 0: the run heads, two sublanes a lane
    bool hd[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 2 * lane + e;
      hd[e] = j < n && key[j] >= 0 &&
              (j % kMatRunCap == 0 || key[j - 1] != key[j]);
    }
    const int mine = hd[0] + hd[1];
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += t;
    }
    int at = incl - mine;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (hd[e]) heads[at++] = 2 * lane + e;
    }
    if (lane == 31) n_heads = incl;
  }
  for (int j = threadIdx.x >> 5; j < n; j += kWarps) {  // dead: zeros
    if (key[j] < 0) {
      reinterpret_cast<float4*>(a.out + (s0 + j) * kLanes)[lane] =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  __syncthreads();
  const long long k = a.k;
  const int q = lane & 7;
  const int units = n_heads * kLanes;
  // every group of a warp takes the same number of steps (shuffles)
  for (int base = 0; base < units; base += kThreads >> 3) {
    const int u = base + (threadIdx.x >> 3);
    const bool active = u < units;
    const int j0 = active ? heads[u >> 7] : 0;
    const int l = u & (kLanes - 1);
    const int sl = key[j0];
    int len = 0;
    while (active && len < kMatRunCap && j0 + len < n && key[j0 + len] == sl &&
           (len == 0 || (j0 + len) % kMatRunCap)) {
      ++len;
    }
    const float* grow = a.g + (static_cast<long long>(sl) * kLanes + l) * k;
    float acc[kMatRunCap];
#pragma unroll
    for (int r = 0; r < kMatRunCap; ++r) acc[r] = 0.0f;
    for (long long col0 = 0; col0 < k; col0 += kCols) {
      const bool in = active && col0 + q * W < k;
      float g[W];
      load_cols<W>(grow + col0 + q * W, in, g);
#pragma unroll
      for (int r = 0; r < kMatRunCap; ++r) {
        float p = 0.0f;
        if (r < len && in) {
          const long long col =
              xrow[j0 + r] + static_cast<long long>(
                                 __ldg(a.lidx + (s0 + j0 + r) * kLanes + l));
          float x[W];
          load_cols<W>(a.x + col * k + col0 + q * W, true, x);
#pragma unroll
          for (int e = 0; e < W; ++e) p += g[e] * x[e];
        }
        acc[r] += group_sum(p);
      }
    }
    if (active && q == 0) {
#pragma unroll
      for (int r = 0; r < kMatRunCap; ++r) {
        if (r < len) a.out[(s0 + j0 + r) * kLanes + l] = acc[r];
      }
    }
  }
}

// Variant 3's unit: step 2 per column block, inside step 3's loop, against
// the block's copy of G; a group takes kUnroll masked lanes of one sublane
// at once, one 16-byte load of each.
constexpr int kUnroll = 4;

template <class Decode, int W, typename V, typename L>
__device__ __forceinline__ void block_unit(const VgArgs<V, L>& a,
                                           VgStage<W>& st) {
  constexpr int kCols = VgStage<W>::kCols;
  const VgUnit un = vg_unit(a.unit_start, a.unit_slice);
  if (!vg_stage<Decode>(a, un, st)) return;
  const float* gblock = a.g + static_cast<long long>(un.slice) * kLanes * a.k;
  const long long k = a.k;
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 3, q = lane & 7;
  for (long long col0 = 0; col0 < k; col0 += kCols) {
    __syncthreads();
    vg_tile_block<W, true>(a, un.n, st, gblock, col0);
    const bool in = col0 + q * W < k;
    for (int j = threadIdx.x >> 5; j < un.n; j += kWarps) {
      const int count = st.off[j + 1] - st.off[j];
      const long long srow = static_cast<long long>(st.sid[j]) * kLanes;
      for (int e0 = 0; e0 < count; e0 += 4 * kUnroll) {
        int ll[kUnroll];
        float x[kUnroll][W];
#pragma unroll
        for (int r = 0; r < kUnroll; ++r) {
          const int e = e0 + 4 * r + grp;
          ll[r] = e < count ? vg_masked_lane(st, j, e) : -1;
          if (ll[r] >= 0) {
            const long long col =
                st.xrow[j] + static_cast<long long>(__ldg(a.lidx + srow + ll[r]));
            load_cols<W>(a.x + col * k + col0 + q * W, in, x[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < kUnroll; ++r) {
          float p = 0.0f;
          if (ll[r] >= 0) {
#pragma unroll
            for (int c = 0; c < W; ++c) p += st.gs[ll[r]][q * W + c] * x[r][c];
          }
          p = group_sum(p);
          if (q == 0 && ll[r] >= 0) st.acc[j][ll[r]] += p;
        }
      }
    }
  }
  __syncthreads();
  vg_store(a, un.n, st);
}

// Variant 5's unit: step 2 by lane, a warp per lane, the lane's G columns
// (a chunk of kP loads a thread) in registers, its four groups taking the
// lane's masked sublanes in turn.
template <class Decode, int W, typename V, typename L>
__device__ __forceinline__ void lanes_unit(const VgArgs<V, L>& a,
                                           VgStage<W>& st) {
  constexpr int kCols = VgStage<W>::kCols;
  constexpr int kP = 8;
  const VgUnit un = vg_unit(a.unit_start, a.unit_slice);
  if (!vg_stage<Decode>(a, un, st)) return;
  const int n = un.n;
  const float* gblock = a.g + static_cast<long long>(un.slice) * kLanes * a.k;
  const long long k = a.k;
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 3, q = lane & 7;
  for (int l2 = threadIdx.x >> 5; l2 < kLanes; l2 += kWarps) {
    const int word = l2 & 3, bit = l2 >> 2;
    const unsigned lo =
        __ballot_sync(kFull, lane < n && ((st.mask[lane][word] >> bit) & 1u));
    const unsigned hi = __ballot_sync(
        kFull, lane + 32 < n && ((st.mask[lane + 32][word] >> bit) & 1u));
    const int n_lo = __popc(lo);
    const int count = n_lo + __popc(hi);
    const float* gr = gblock + l2 * k + q * W;
    for (long long c0 = 0; c0 < k; c0 += kP * kCols) {
      float g[kP][W];
#pragma unroll
      for (int b = 0; b < kP; ++b) {
        const long long c = c0 + b * kCols;
        load_cols<W>(gr + c, c + q * W < k, g[b]);
      }
      for (int e0 = 0; e0 < count; e0 += 4) {
        const int e = e0 + grp;
        int j = 0;
        float p = 0.0f;
        if (e < count) {  // the e-th sublane whose lane l2 is masked
          unsigned w2 = e < n_lo ? lo : hi;
          for (int rest = e < n_lo ? e : e - n_lo; rest > 0; --rest) {
            w2 &= w2 - 1;
          }
          j = __ffs(w2) - 1 + (e < n_lo ? 0 : 32);
          const long long col =
              st.xrow[j] +
              static_cast<long long>(__ldg(
                  a.lidx + static_cast<long long>(st.sid[j]) * kLanes + l2));
          const auto* xr = a.x + col * k + q * W;
#pragma unroll
          for (int b = 0; b < kP; ++b) {
            const long long c = c0 + b * kCols;
            float x[W];
            load_cols<W>(xr + c, c + q * W < k, x);
#pragma unroll
            for (int cc = 0; cc < W; ++cc) p += g[b][cc] * x[cc];
          }
        }
        p = group_sum(p);
        if (q == 0 && e < count) st.acc[j][l2] += p;
      }
    }
  }
  for (long long col0 = 0; col0 < k; col0 += kCols) {
    __syncthreads();
    vg_tile_block<W, true>(a, n, st, gblock, col0);
  }
  __syncthreads();
  vg_store(a, n, st);
}

template <int Variant, class Decode, int W, typename V, typename L>
__global__ void __launch_bounds__(kThreads, kVgMinBlocks)
    body_kernel(const VgArgs<V, L> a) {
  extern __shared__ __align__(16) unsigned char vg_smem[];
  VgStage<W>& st = *reinterpret_cast<VgStage<W>*>(vg_smem);
  if constexpr (Variant == 2) {
    vals_grad_unit<Decode, W, false>(a, st);
  } else if constexpr (Variant == 3) {
    block_unit<Decode, W>(a, st);
  } else if constexpr (Variant == 4) {
    vals_grad_unit<Decode, W, true, 8>(a, st);
  } else {
    lanes_unit<Decode, W>(a, st);
  }
}

template <class Decode, typename V, typename L>
cudaError_t launch_variant(int variant, VgArgs<V, L> a, cudaStream_t stream) {
  long long items = 0;
  if (a.k < 1 || !sublane_items(a, &items)) return cudaErrorInvalidValue;
  const bool vec = a.k % 4 == 0;
  void (*mat_kernel)(MatArgs<V, L>) = nullptr;
  void (*vg_kernel)(VgArgs<V, L>) = nullptr;
  dim3 grid;
  int smem = 0;
  if (variant == 0) {
    mat_kernel = walk_kernel<Decode, V, L>;
    grid = dim3(static_cast<unsigned>((a.n_slots + kThreads - 1) / kThreads));
  } else if (variant == 1) {
    if (vec) mat_kernel = run_kernel<Decode, 4, V, L>;
    else mat_kernel = run_kernel<Decode, 1, V, L>;
    grid = dim3(static_cast<unsigned>(items));
  } else if (variant >= 2 && variant <= 5) {
    if (a.n_units < 1) return cudaErrorInvalidValue;
    if (variant == 2) {
      if (vec) vg_kernel = body_kernel<2, Decode, 4, V, L>;
      else vg_kernel = body_kernel<2, Decode, 1, V, L>;
    } else if (variant == 3) {
      if (vec) vg_kernel = body_kernel<3, Decode, 4, V, L>;
      else vg_kernel = body_kernel<3, Decode, 1, V, L>;
    } else if (variant == 4) {
      if (vec) vg_kernel = body_kernel<4, Decode, 4, V, L>;
      else vg_kernel = body_kernel<4, Decode, 1, V, L>;
    } else if (variant == 5) {
      if (vec) vg_kernel = body_kernel<5, Decode, 4, V, L>;
      else vg_kernel = body_kernel<5, Decode, 1, V, L>;
    }
    smem = vec ? sizeof(VgStage<4>) : sizeof(VgStage<1>);
    cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(vg_kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    grid = dim3(static_cast<unsigned>(a.n_units));
  } else {
    return cudaErrorInvalidValue;
  }
  // the walk and the run form take a MatArgs, the by-slice body VgArgs
  MatArgs<V, L> m = a;
  void* params_m[] = {&m};
  void* params_v[] = {&a};
  const void* kernel = vg_kernel != nullptr
                           ? reinterpret_cast<const void*>(vg_kernel)
                           : reinterpret_cast<const void*>(mat_kernel);
  cudaError_t err = cudaLaunchKernel(kernel, grid, dim3(kThreads),
                                     vg_kernel ? params_v : params_m, smem,
                                     stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Arguments as sell_vals_grad_launch, after the variant id (the schedule
// is read by variants 2-5 only).
extern "C" int sell_vals_grad_variant_launch(
    int variant, int route, const void* lidx, const void* meta,
    const void* slice, const void* tile_base, const void* x, const void* g,
    void* out, const void* order, const void* unit_start,
    const void* unit_slice, int n_units, long long n_slots, int chunk, int k,
    int value_kind, int lidx_kind, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = sell::with_types(value_kind, lidx_kind, [&](auto v, auto l) {
    using V = typename decltype(v)::type;
    using L = typename decltype(l)::type;
    VgArgs<V, L> a{};
    a.lidx = static_cast<const L*>(lidx);
    a.meta = static_cast<const int*>(meta);
    a.slice = static_cast<const int*>(slice);
    a.tile_base = static_cast<const int*>(tile_base);
    a.x = static_cast<const V*>(x);
    a.g = static_cast<const float*>(g);
    a.out = static_cast<float*>(out);
    a.n_slots = n_slots;
    a.chunk = chunk;
    a.k = k;
    a.order = static_cast<const int*>(order);
    a.unit_start = static_cast<const int*>(unit_start);
    a.unit_slice = static_cast<const int*>(unit_slice);
    a.n_units = n_units;
    if (route == kRelsl) return launch_variant<MergedWord>(variant, a, st);
    if (route == kSplit && a.slice != nullptr) {
      return launch_variant<SplitPlanes>(variant, a, st);
    }
    return cudaErrorInvalidValue;
  });
  return static_cast<int>(err);
}
