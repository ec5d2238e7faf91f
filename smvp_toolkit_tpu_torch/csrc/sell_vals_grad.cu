// SELL-T1 values-gradient kernel for Hopper (sm_90a): the cotangent of the
// SpMM Y = A(vals)·X with respect to the values plane, for output
// cotangent G.
//
// Replaces _make_vals_grad_kernel of the JAX package's ops/spmv_pallas.py
// (K7, via _sell_vals_grad_call :998, launched :1028 with a window stack
// and :1051 with a resident x), for every k >= 1:
//   sell_vals_grad_kernel
//     out[s, l] = sum over j < k of G[slice(s)·128 + l, j] * X[col(s,l), j]
// on all 128 lanes of every live sublane: a padding lane of a live sublane
// carries its true partial (its lane index is 0, so it reads the first
// column of its tile), as the TPU kernel's does. A dead sublane (rel or
// slice dead, sell_common.cuh) is exactly 0. The values plane itself is
// not read: SpMM is bilinear. The TPU kernel selects both factors with
// one-hot MXU products because the TPU has no fast gather; here they are
// plain gathers of X and G rows. X is read in its storage type (float32 or
// bfloat16), G is float32, products and sums float32.
//
// Schedule: by slice. Every output row of a slice, G[slice·128 + l, :],
// is read by every live sublane of that slice, and a sublane's padding
// lanes (lane index 0; 84% of gcn_arxiv A's slots) all read its tile's
// first X row. So the wrapper builds, once per plan (ops/spmv_sell.py,
// vals_grad_schedule), an index of the live sublanes grouped by slice
// (plan order within a slice), cut into units of one slice (at most 32
// sublanes by default, VG_CAP there; at most kVgRun, which the shared
// memory holds), followed by the dead sublanes in such units (slice -1).
// A block takes one unit (blockIdx.x):
//  1. Stage. Thread j < n stages the unit's j-th sublane: its id and the
//     first X row of its tile. Warp w takes sublanes w, w + 8, ...: one
//     vector load of four lane indices a thread and four ballots give the
//     sublane's mask of lanes whose index is not 0 (word w, bit t = lane
//     4t + w); warp 0 counts the masked lanes before each sublane. A unit
//     of dead sublanes stores zeros and ends here.
//  2. Lanes of index != 0 (the nonzero entries, and only they gather): the
//     unit's masked lanes are dealt out evenly to the block's 32 groups of
//     eight threads; a group takes one lane at a time and reads its whole X
//     row and G row (G[slice·128 + lane, :], from G itself, mostly L2 hits
//     within the unit), each thread W columns of every column block of
//     8·W, kRowBlocks column blocks a load round (16-byte loads in f32:
//     coalesced 128 bytes a row a block), sums its products in order, and
//     three __shfl_xor_sync steps add the eight partials.
//  3. Lanes of index 0 (the padding, and the entries in the tile's first
//     column): column blocks of kCols = 8·W columns (W = 4: float4 of f32 or
//     four bf16 where k % 4 == 0; W = 1: single columns), in order. The
//     block copies the slice's G block (128 rows x kCols) and the unit's
//     tile rows (n x kCols) into shared memory (coalesced); thread (l, h)
//     holds G[l, block] in registers and, for the sublanes j = h, h + 2,
//     ... whose lane l has index 0, adds the dot product with the staged
//     tile row j (a broadcast read).
//     Steps 2 and 3 write the unit's outputs in shared memory (n x 128
//     floats), each (sublane, lane) owned by one thread, so no atomics.
//  4. Store: one coalesced float4 store a thread, every word of the unit's
//     sublanes.
// Every word of the plane is written (live sublanes by their unit, dead
// ones by theirs), so the wrapper allocates it with torch.empty. The
// summation order is fixed (a gathered lane: each thread's columns in
// order, then the eight partials by a fixed butterfly; a lane of index 0:
// column blocks in order, the kCols products of a block in order), so the
// result is the same on every run; it differs from the ascending sum over
// j in the last bits. Gathering a lane's row per column block instead
// (128 bytes at a time, eight times over the column loop) took 2.2x as
// long at gcn_arxiv k = 256 (bench/bench_variants.py --vgrad, variant
// block).
//
// Bound on this card: bytes. A launch copies each G block once per unit
// (gcn_arxiv A: 1,323 slices of 52.4 live sublanes on average, 71 at most,
// in 2,666 units of at most 32: about twice a slice, the second copy
// mostly from L2) and reads each gathered lane's G row again (mostly
// from L2), one tile row per live sublane, one X row per lane whose
// index is not 0 (the nonzero entries: 1,448,814 rows of 1 KB at k = 256,
// the same gathers torch.sparse.sampled_addmm makes), the lane-index plane
// and the metadata once, and writes the (S, 128) plane once; 2·k flops per
// slot of a live sublane. Before (one thread per slot, a warp per 32
// slots, a G row and an X row a slot, a five-step butterfly per slot) it
// read 9.09 GB of G rows at gcn_arxiv k = 256 and took 2.544 ms against
// sampled_addmm's 1.051 ms (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py).
//
// C interface (ctypes) as in sell_spmm.cu: planes that are not whole
// chunks, a schedule of no unit, or a k < 1 return cudaErrorInvalidValue;
// a lane-index plane not aligned to four elements, an output plane not
// aligned to 16 bytes, or (where k % 4 == 0) X not aligned to four
// elements or G not to 16 bytes, cudaErrorMisalignedAddress; neither
// launches anything.

#include "sell_common.cuh"

namespace {

using namespace sell;

// Sublanes a unit holds at most (ops/spmv_sell.py, VG_RUN, cuts the
// schedule's units at it).
constexpr int kVgRun = 64;
static_assert(kVgRun == 64, "step 1's offsets give each lane of warp 0 two sublanes");
constexpr int kVgMinBlocks = 3;  // co-resident blocks per SM (shared memory)

// Everything the kernel reads: the k-column planes (MatArgs) and the
// by-slice schedule.
template <typename V, typename L>
struct VgArgs : MatArgs<V, L> {
  const int* order;       // sublanes: live ones by slice, then dead ones
  const int* unit_start;  // n_units + 1 offsets into order
  const int* unit_slice;  // per unit: its slice, -1 for dead sublanes
  int n_units;
};

// The shared memory of one unit, for columns of W elements a load.
template <int W>
struct VgStage {
  static constexpr int kCols = 8 * W;      // columns of a column block
  static constexpr int kPitch = kCols + W;  // G rows: no bank conflicts
  float acc[kVgRun][kLanes];                // the unit's outputs
  float gs[kLanes][kPitch];                 // G block, this column block
  float xs[kVgRun][kCols];                  // each sublane's tile row
  unsigned mask[kVgRun][4];                 // lanes of index != 0
  long long xrow[kVgRun];                   // first X row of its tile
  int sid[kVgRun];                          // the sublane
  int off[kVgRun + 1];                      // masked lanes before j
};

// W elements of X or G (load_x: the read-only path, bf16 widened), or
// zeros past the row's last column.
template <int W, typename T>
__device__ __forceinline__ void load_cols(const T* p, bool in, float (&v)[W]) {
  if (in) {
    load_x(p, v);
  } else {
#pragma unroll
    for (int e = 0; e < W; ++e) v[e] = 0.0f;
  }
}

// The eight threads of a group (lanes 8g .. 8g + 7) sum their partials.
__device__ __forceinline__ float group_sum(float p) {
  p += __shfl_xor_sync(kFull, p, 4);
  p += __shfl_xor_sync(kFull, p, 2);
  p += __shfl_xor_sync(kFull, p, 1);
  return p;
}

// The unit's sublanes and its slice (-1: dead sublanes).
struct VgUnit {
  int first;  // offset into the schedule's order
  int n;      // sublanes
  int slice;
};

__device__ __forceinline__ VgUnit vg_unit(const int* unit_start,
                                          const int* unit_slice) {
  const int u = blockIdx.x;
  return VgUnit{unit_start[u], unit_start[u + 1] - unit_start[u],
                unit_slice[u]};
}

// Step 1. False for a unit of dead sublanes, whose words it zeroes.
template <class Decode, int W, typename V, typename L>
__device__ __forceinline__ bool vg_stage(const VgArgs<V, L>& a,
                                         const VgUnit& un, VgStage<W>& st) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x < un.n) {
    const int s = a.order[un.first + threadIdx.x];
    st.sid[threadIdx.x] = s;
    long long rel = 0, sl = 0;
    st.xrow[threadIdx.x] =
        un.slice >= 0 &&
                Decode::decode(a, static_cast<long long>(s) * kLanes, &rel,
                               &sl)
            ? (static_cast<long long>(a.tile_base[s / a.chunk]) + rel) * kLanes
            : 0;
  }
  __syncthreads();
  if (un.slice < 0) {  // dead sublanes: exactly 0
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int j = warp; j < un.n; j += kWarps) {
      reinterpret_cast<float4*>(
          a.out + static_cast<long long>(st.sid[j]) * kLanes)[lane] = zero;
    }
    return false;
  }
  for (int j = warp; j < un.n; j += kWarps) {
    int li[4];
    load_lanes<ReadOnly>(
        a.lidx + static_cast<long long>(st.sid[j]) * kLanes + 4 * lane, li);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const unsigned m = __ballot_sync(kFull, li[w] != 0);
      if (lane == 0) st.mask[j][w] = m;
    }
  }
  for (int i = threadIdx.x; i < un.n * kLanes; i += kThreads) {
    st.acc[i / kLanes][i % kLanes] = 0.0f;
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // warp 0: masked lanes before each sublane
    int c2[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 2 * lane + e;
      c2[e] = 0;
      if (j < un.n) {
#pragma unroll
        for (int w = 0; w < 4; ++w) c2[e] += __popc(st.mask[j][w]);
      }
    }
    const int pair = c2[0] + c2[1];
    int incl = pair;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += t;
    }
    st.off[2 * lane] = incl - pair;
    st.off[2 * lane + 1] = incl - pair + c2[0];
    if (lane == 31) st.off[kVgRun] = incl;
  }
  __syncthreads();
  return true;
}

// Sublane j's e-th masked lane (the words of its mask in order).
template <int W>
__device__ __forceinline__ int vg_masked_lane(const VgStage<W>& st, int j,
                                              int e) {
  int w = 0;
  unsigned word = st.mask[j][0];
  while (e >= __popc(word)) {
    e -= __popc(word);
    word = st.mask[j][++w];
  }
  for (; e > 0; --e) word &= word - 1;
  return 4 * (__ffs(word) - 1) + w;
}

// Step 2: the masked lanes, each gathered whole by a group of eight, in
// rounds of RowBlocks column blocks of loads.
template <int W, int RowBlocks, typename V, typename L>
__device__ __forceinline__ void vg_gather_rows(const VgArgs<V, L>& a,
                                               VgStage<W>& st,
                                               const float* gblock) {
  constexpr int kCols = VgStage<W>::kCols;
  const long long k = a.k;
  const int q = threadIdx.x & 7;
  const int total = st.off[kVgRun];
  for (int e0 = 0; e0 < total; e0 += kThreads / 8) {
    const int e = e0 + (threadIdx.x >> 3);
    int j = 0, ll = 0;
    float p = 0.0f;
    if (e < total) {
      int lo = 0, hi = kVgRun;  // st.off[lo] <= e < st.off[lo + 1]
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (st.off[mid] <= e) lo = mid;
        else hi = mid;
      }
      j = lo;
      ll = vg_masked_lane(st, j, e - st.off[j]);
      const long long col =
          st.xrow[j] +
          static_cast<long long>(__ldg(
              a.lidx + static_cast<long long>(st.sid[j]) * kLanes + ll));
      const auto* xr = a.x + col * k + q * W;
      const float* gr = gblock + ll * k + q * W;
      for (long long c0 = 0; c0 < k; c0 += RowBlocks * kCols) {
        float xv[RowBlocks][W], gv[RowBlocks][W];
#pragma unroll
        for (int b = 0; b < RowBlocks; ++b) {
          const long long c = c0 + b * kCols;
          load_cols<W>(xr + c, c + q * W < k, xv[b]);
          load_cols<W>(gr + c, c + q * W < k, gv[b]);
        }
#pragma unroll
        for (int b = 0; b < RowBlocks; ++b) {
#pragma unroll
          for (int c = 0; c < W; ++c) p += gv[b][c] * xv[b][c];
        }
      }
    }
    p = group_sum(p);
    if (q == 0 && e < total) st.acc[j][ll] = p;
  }
}

// Step 3, one column block from col0: the copies of the G block (StageG)
// and of the tile rows, then the lanes of index 0 against the tile rows.
// Call between __syncthreads() that order it after the step that wrote
// acc before it and the next column block's copies.
template <int W, bool StageG, typename V, typename L>
__device__ __forceinline__ void vg_tile_block(const VgArgs<V, L>& a, int n,
                                              VgStage<W>& st,
                                              const float* gblock,
                                              long long col0) {
  constexpr int kCols = VgStage<W>::kCols;
  constexpr int kQ = kCols / W;  // loads a row of a column block: 8
  const long long k = a.k;
  for (int i = threadIdx.x; StageG && i < kLanes * kQ; i += kThreads) {
    const int r = i / kQ, c = (i % kQ) * W;
    float v[W];
    load_cols<W>(gblock + r * k + col0 + c, col0 + c < k, v);
#pragma unroll
    for (int e = 0; e < W; ++e) st.gs[r][c + e] = v[e];
  }
  for (int i = threadIdx.x; i < n * kQ; i += kThreads) {
    const int j = i / kQ, c = (i % kQ) * W;
    float v[W];
    load_cols<W>(a.x + st.xrow[j] * k + col0 + c, col0 + c < k, v);
#pragma unroll
    for (int e = 0; e < W; ++e) st.xs[j][c + e] = v[e];
  }
  __syncthreads();
  const int l = threadIdx.x & (kLanes - 1);  // the lane
  float g[kCols];
  if (StageG) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) g[c] = st.gs[l][c];
  } else {
#pragma unroll
    for (int c = 0; c < kCols; c += W) {
      float v[W];
      load_cols<W>(gblock + l * k + col0 + c, col0 + c < k, v);
#pragma unroll
      for (int e = 0; e < W; ++e) g[c + e] = v[e];
    }
  }
  const int word = l & 3, bit = l >> 2;
  for (int j = threadIdx.x >> 7; j < n; j += 2) {  // the sublanes j = h mod 2
    if ((st.mask[j][word] >> bit) & 1u) continue;
    float p = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) p += g[c] * st.xs[j][c];
    st.acc[j][l] += p;
  }
}

// Step 4: one float4 store a thread per sublane.
template <int W, typename V, typename L>
__device__ __forceinline__ void vg_store(const VgArgs<V, L>& a, int n,
                                         const VgStage<W>& st) {
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < n; j += kWarps) {
    reinterpret_cast<float4*>(
        a.out + static_cast<long long>(st.sid[j]) * kLanes)[lane] =
        reinterpret_cast<const float4*>(st.acc[j])[lane];
  }
}

// The kernel's unit. StageG: step 3 reads G from the block's copy in
// shared memory (the kernel) or from G itself; RowBlocks: column blocks a
// load round in step 2 (the kernel: kRowBlocks). The other values, and
// other steps 2, are variants (csrc/variants/sell_vals_grad_variants.cu).
constexpr int kRowBlocks = 4;

template <class Decode, int W, bool StageG = true, int RowBlocks = kRowBlocks,
          typename V, typename L>
__device__ __forceinline__ void vals_grad_unit(const VgArgs<V, L>& a,
                                               VgStage<W>& st) {
  const VgUnit un = vg_unit(a.unit_start, a.unit_slice);
  if (!vg_stage<Decode>(a, un, st)) return;
  const float* gblock = a.g + static_cast<long long>(un.slice) * kLanes * a.k;
  vg_gather_rows<W, RowBlocks>(a, st, gblock);
  for (long long col0 = 0; col0 < a.k; col0 += VgStage<W>::kCols) {
    __syncthreads();  // step 2's writes, or the last block's reads
    vg_tile_block<W, StageG>(a, un.n, st, gblock, col0);
  }
  __syncthreads();
  vg_store(a, un.n, st);
}

template <class Decode, int W, typename V, typename L>
__global__ void __launch_bounds__(kThreads, kVgMinBlocks)
    sell_vals_grad_kernel(const VgArgs<V, L> a) {
  extern __shared__ __align__(16) unsigned char vg_smem[];
  vals_grad_unit<Decode, W>(a, *reinterpret_cast<VgStage<W>*>(vg_smem));
}

template <typename V, typename L>
using VgKernel = void (*)(VgArgs<V, L>);

template <class Decode, typename V, typename L>
VgKernel<V, L> width_kernel(int k) {
  if (k % 4 == 0) return sell_vals_grad_kernel<Decode, 4, V, L>;
  return sell_vals_grad_kernel<Decode, 1, V, L>;
}

template <typename V, typename L>
cudaError_t launch_vals_grad(int route, VgArgs<V, L> a, cudaStream_t stream) {
  VgKernel<V, L> kernel = nullptr;
  if (route == kRelsl) kernel = width_kernel<MergedWord, V, L>(a.k);
  if (route == kSplit && a.slice != nullptr) {
    kernel = width_kernel<SplitPlanes, V, L>(a.k);
  }
  long long items = 0;
  if (kernel == nullptr || a.k < 1 || !sublane_items(a, &items) ||
      a.n_units < 1 || a.order == nullptr || a.unit_start == nullptr ||
      a.unit_slice == nullptr) {
    return cudaErrorInvalidValue;
  }
  const auto at = [](const void* p, size_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  if (!at(a.lidx, 4 * sizeof(L)) || !at(a.out, 16) ||
      (a.k % 4 == 0 && (!at(a.x, 4 * sizeof(V)) || !at(a.g, 16)))) {
    return cudaErrorMisalignedAddress;
  }
  const int smem = a.k % 4 == 0 ? sizeof(VgStage<4>) : sizeof(VgStage<1>);
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  void* params[] = {&a};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel),
                         dim3(static_cast<unsigned>(a.n_units)),
                         dim3(kThreads), params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// route: sell::kRelsl (merged word in meta, slice null) or sell::kSplit
// (rel_tile in meta, slice_of in slice). value_kind: 0 = float32,
// 1 = bfloat16 (X). lidx_kind: 0 = int8, 1 = int32. X and G have k
// columns; out is the (n_slots / 128, 128) float32 gradient plane. order,
// unit_start and unit_slice are the by-slice schedule (int32; n_units
// units of at most kVgRun sublanes, ops/spmv_sell.py vals_grad_schedule).
extern "C" int sell_vals_grad_launch(
    int route, const void* lidx, const void* meta, const void* slice,
    const void* tile_base, const void* x, const void* g, void* out,
    const void* order, const void* unit_start, const void* unit_slice,
    int n_units, long long n_slots, int chunk, int k, int value_kind,
    int lidx_kind, int device, void* stream) {
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
    return launch_vals_grad(route, a, st);
  });
  return static_cast<int>(err);
}

