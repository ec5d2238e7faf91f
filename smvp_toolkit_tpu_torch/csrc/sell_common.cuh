// The two bodies of the SELL-T1 SpMV that the forward and bench kernels
// (csrc/sell_spmv.cu, csrc/sell_bench.cu, csrc/sell_packed.cu) run: one
// warp per sublane (`sublane_run`: every k = 1 kernel of the four routes,
// forward and N-iteration: K1, K2, K3-relsl and K2 streamed on the merged
// word, K3-split, K2 streamed split, K4 and K2 split on the split planes)
// and one thread per slot (`slot`: the packed route, K2-packed among it,
// and the fused solvers). The decode policies, the slot coordinates, the
// warp walk over k columns and the cooperative grid also serve the
// k-column kernels (csrc/sell_spmm.cu, csrc/sell_vals_grad.cu) and the
// fused solvers (csrc/sell_solvers.cu).
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
// full int32) and plans of 180M slots occur. Each slot pays for that: a
// 64-bit divide for its chunk, its chunk's and sublane's metadata loads
// and 64-bit address arithmetic.
//
// One warp per sublane (the section below `sublane_run`): a block takes a
// run of sublanes inside one chunk, reads the chunk's metadata once and
// stages the run's rel and slice ids in shared memory (from the merged
// word, one load per sublane, or from the two split planes); each thread
// covers four consecutive lanes with one vector load of values and one of
// lane indices, and adds its four products with one vector atomic.

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
  // The warp-per-sublane body's staging of sublane s: its rel and slice,
  // -1 in both when either field is dead.
  template <class A>
  __device__ __forceinline__ static void stage(const A& a, long long s,
                                               int* rel, int* slice) {
    const unsigned word = static_cast<unsigned>(a.meta[s]);
    const unsigned r = word & kRelDead;
    const unsigned sl = word >> kSliceShift;
    const bool dead = r == kRelDead || sl == kSliceDead;
    *rel = dead ? -1 : static_cast<int>(r);
    *slice = dead ? -1 : static_cast<int>(sl);
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
  template <class A>
  __device__ __forceinline__ static void stage(const A& a, long long s,
                                               int* rel, int* slice) {
    *rel = a.meta[s];
    *slice = a.slice[s];
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

// The one-thread-per-slot N-iteration body (one cooperative launch;
// K2-packed): each iteration zeroes ALL of y in a grid-stride loop,
// grid.sync(), sweeps every slot, grid.sync(). The TPU grid runs in order
// and re-zeroes y when an iteration (or, streamed, a y block) starts; on
// Hopper blocks run in no order, and zeroing all of y keeps a block that no
// chunk visits at zero.
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

// ---------------------------------------------------------------------------
// One warp per sublane, under a staging policy (MergedWord: K1 and K2 on a
// resident y, K3-relsl and K2 streamed on a streamed one; SplitPlanes:
// K3-split and K2 streamed split on a streamed y, K4 and K2 split on a
// resident one) and a y policy.
//
// Work item `item` is run r = item % runs of chunk c = item / runs: up to
// kRun consecutive sublanes of one chunk (chunks never straddle a y block
// in a streamed plan), so c, tile_base[c] and the chunk's y base come once
// per item in 32-bit index arithmetic, with one 64-bit base per run and
// 32-bit offsets inside it. The block stages the run's rel and slice ids
// in shared memory (Stage::stage: thread t loads sublane s0 + t's merged
// word and decodes it, -1 in both where rel or slice is dead; or its two
// split words), then each warp walks every
// kWarps-th sublane: a dead one (rel < 0 or slice < 0) is skipped before
// any plane load; a live one costs each thread one 16-byte load of four
// values (8 bytes in bf16), one load of four lane indices (4 bytes int8,
// 16 bytes int32), four gathers of x and one float4 atomic into its four
// consecutive rows (red.global.add.v4.f32, sm_90), left out when all four
// products are exactly zero. Every slot of a live sublane is multiplied,
// padding (v = 0) included, so Inf or NaN in x at a padding lane's column
// lands NaN in its row, as in the one-thread-per-slot body; padding lanes
// carry lane index 0, so their gathers read one address per sublane. The
// plane loads are streaming (the Streaming policy: read once, kept out of
// L1, where the gathered x tiles stay).
//
// Planes must be aligned for the vector loads (values to 4 elements, lane
// indices to 4 elements, y to 16 bytes), and whole chunks: the launchers
// return cudaErrorMisalignedAddress or cudaErrorInvalidValue and launch
// nothing otherwise. The kernels are built with __launch_bounds__(kThreads,
// kSublaneMinBlocks): 32 registers a thread, eight blocks on an SM.

constexpr int kWarps = kThreads / 32;
constexpr int kRun = 64;              // sublanes per work item
constexpr int kSublaneMinBlocks = 8;  // co-resident blocks per SM
static_assert(kRun <= kThreads, "one staging load per thread");

__host__ __device__ inline int runs_per_chunk(int chunk) {
  return (chunk + kRun - 1) / kRun;
}

// The plane loads' cache policy. Streaming: __ldcs, evict-first in L1
// and L2, since a sweep reads each plane byte once and the gathered x
// tiles should keep the caches.
struct Streaming {
  template <typename T>
  __device__ __forceinline__ static T load(const T* p) {
    return __ldcs(p);
  }
};

template <class Load>
__device__ __forceinline__ void load_values(const float* p, float (&v)[4]) {
  const float4 q = Load::load(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// bf16 bits are the high half of the float32 with the same value.
template <class Load>
__device__ __forceinline__ void load_values(const __nv_bfloat16* p,
                                            float (&v)[4]) {
  const uint2 q = Load::load(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}

template <class Load>
__device__ __forceinline__ void load_lanes(const int8_t* p, int (&l)[4]) {
  const int w = Load::load(reinterpret_cast<const int*>(p));
#pragma unroll
  for (int i = 0; i < 4; ++i) l[i] = static_cast<int8_t>(w >> (8 * i));
}

template <class Load>
__device__ __forceinline__ void load_lanes(const int32_t* p, int (&l)[4]) {
  const int4 q = Load::load(reinterpret_cast<const int4*>(p));
  l[0] = q.x;
  l[1] = q.y;
  l[2] = q.z;
  l[3] = q.w;
}

// y[0..3] += p in one vector atomic, unless all four products are zero.
__device__ __forceinline__ void add_rows4(float* y, const float (&p)[4]) {
  if (p[0] == 0.0f && p[1] == 0.0f && p[2] == 0.0f && p[3] == 0.0f) return;
  atomicAdd(reinterpret_cast<float4*>(y), make_float4(p[0], p[1], p[2], p[3]));
}

// All kThreads threads of the block call it with the same item; the
// products land in `out` (a.y, or one of the N-iteration body's two y
// buffers). `Load` is the plane loads' cache policy.
template <class Stage, class YAddr, class Load = Streaming, typename V,
          typename L>
__device__ __forceinline__ void sublane_run(const Args<V, L>& a, float* out,
                                            int runs, int item, int* s_rel,
                                            int* s_slice) {
  const int c = item / runs;
  const int first = (item - c * runs) * kRun;
  const int n = min(kRun, a.chunk - first);
  const long long s0 = static_cast<long long>(c) * a.chunk + first;
  const long long tile0 = a.tile_base[c];
  const long long ybase = YAddr::base(a, c);
  if (threadIdx.x < n) {
    Stage::stage(a, s0 + threadIdx.x, &s_rel[threadIdx.x],
                 &s_slice[threadIdx.x]);
  }
  __syncthreads();
  const int lane4 = 4 * (threadIdx.x & 31);
  const V* vals = a.vals + s0 * kLanes + lane4;
  const L* lidx = a.lidx + s0 * kLanes + lane4;
  float* y = out + ybase * kLanes + lane4;
  for (int j = threadIdx.x >> 5; j < n; j += kWarps) {
    const int rel = s_rel[j];
    const int slice = s_slice[j];
    if (rel < 0 || slice < 0) continue;
    float v[4];
    int l[4];
    load_values<Load>(vals + j * kLanes, v);
    load_lanes<Load>(lidx + j * kLanes, l);
    const V* xt = a.x + (tile0 + rel) * kLanes;
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = v[i] * to_f32(__ldg(xt + l[i]));
    add_rows4(y + static_cast<long long>(slice) * kLanes, p);
  }
  __syncthreads();  // the next item restages s_rel and s_slice
}

// The forward kernel's body: work item blockIdx.x.
template <class Stage, class YAddr, typename V, typename L>
__device__ __forceinline__ void sublane_sweep(const Args<V, L>& a) {
  __shared__ int s_rel[kRun], s_slice[kRun];
  sublane_run<Stage, YAddr>(a, a.y, runs_per_chunk(a.chunk), blockIdx.x,
                            s_rel, s_slice);
}

// The N-iteration body (one cooperative launch), in one of two forms.
// YBuffers = 1: each iteration zeroes all of y (float4 stores),
// grid.sync(), walks the work items in a grid-stride loop, grid.sync():
// two barriers an iteration. YBuffers = 2: two y buffers, y[0] = a.y and
// y[1] = a.y + n_out, taken in turn: y[0] is zeroed before the first
// iteration, grid.sync(); iteration `it` zeroes y[(it + 1) % 2] and walks
// the work items into y[it % 2], and one grid.sync() ends it: one barrier
// an iteration, and the result in y[(N - 1) % 2]. Neither form has a
// barrier after the last iteration. Zeroing all of a buffer (not only the
// y blocks that chunks visit) keeps a block that no chunk visits at zero.
// Which form a kernel takes was measured (csrc/sell_bench.cu).
template <class Stage, class YAddr, int YBuffers, class Load = Streaming,
          typename V, typename L>
__device__ __forceinline__ void sublane_bench_sweeps(const Args<V, L>& a) {
  static_assert(YBuffers == 1 || YBuffers == 2, "one or two y buffers");
  __shared__ int s_rel[kRun], s_slice[kRun];
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
  if (YBuffers == 2) {
    for (long long i = tid; i < n4; i += stride) y4[i] = zero;
    grid.sync();
  }
  for (int it = 0; it < a.iterations; ++it) {
    const bool more = it + 1 < a.iterations;
    float* out = a.y;
    if (YBuffers == 2) {
      if (more) {
        float4* next = y4 + ((it + 1) & 1) * n4;
        for (long long i = tid; i < n4; i += stride) next[i] = zero;
      }
      out += (it & 1) * a.n_out;
    } else {
      for (long long i = tid; i < n4; i += stride) y4[i] = zero;
      grid.sync();
    }
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      sublane_run<Stage, YAddr, Load>(a, out, runs, item, s_rel, s_slice);
    }
    if (more) grid.sync();
  }
}

// The work items of a launch (chunks x runs per chunk); false unless the
// planes are whole chunks and the items fit a grid.
template <typename V, typename L>
bool sublane_items(const Args<V, L>& a, long long* items) {
  if (a.chunk < 1 || a.n_slots < 1) return false;
  const long long per_chunk = static_cast<long long>(kLanes) * a.chunk;
  if (a.n_slots % per_chunk) return false;
  *items = a.n_slots / per_chunk * runs_per_chunk(a.chunk);
  return *items <= 0x7fffffffLL;
}

// The vector loads and atomics: values and lane indices aligned to four
// elements, y to 16 bytes.
template <typename V, typename L>
bool sublane_aligned(const Args<V, L>& a) {
  const auto at = [](const void* p, size_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  return at(a.vals, 4 * sizeof(V)) && at(a.lidx, 4 * sizeof(L)) &&
         at(a.y, 16);
}

// ---------------------------------------------------------------------------
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
