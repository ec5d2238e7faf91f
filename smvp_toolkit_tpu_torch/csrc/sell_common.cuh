// The bodies of the SELL-T1 SpMV and SpMM kernels (csrc/sell_spmv.cu,
// csrc/sell_bench.cu, csrc/sell_spmm.cu, csrc/sell_packed.cu): one warp per
// sublane (`sublane_run`: every k = 1 kernel of the four routes, forward
// and N-iteration: K1, K2, K3-relsl and K2 streamed on the merged word,
// K3-split, K2 streamed split, K4 and K2 split on the split planes,
// K2-subwin on the merged word under its window rule, SubwinWord, K5 and
// K2-packed on the packed word, PackedStage and PackedShuffle; and the
// SpMV phases of K10 and K11 in csrc/sell_solvers.cu), its k-column form
// (`sublane_mat_run`: K1 and K4 with k columns, and K2 with k columns in
// its N-iteration walk `sublane_mat_bench_sweeps`), and one thread per slot
// (`slot`: K9, the fused CG; `warp_slots`, a warp walk over k columns: K5
// with k columns under PackedLaneZero). The decode policies, the slot
// coordinates and the cooperative grid also serve the values gradient
// (csrc/sell_vals_grad.cu), the fused solvers (csrc/sell_solvers.cu) and
// the double-float kernels (csrc/sell_df64.cu).
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
// word, one load per sublane, from the two split planes, or from the
// packed word of lane 0 and slice_of); each thread covers four consecutive
// lanes with one vector load of values and one of lane indices (on the
// packed word one 16-byte load of four words), and adds its four products
// with one vector atomic.

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
constexpr unsigned kFull = 0xffffffffu;  // all lanes of a warp

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

// The plane loads' cache policy. Streaming: __ldcs, evict-first in L1
// and L2, since a sweep reads each plane byte once and the gathered x
// tiles should keep the caches.
struct Streaming {
  template <typename T>
  __device__ __forceinline__ static T load(const T* p) {
    return __ldcs(p);
  }
};

// The read-only path: L1 and L2 allocating. Non-coherent (ld.global.nc):
// only for data that no thread writes while the kernel runs.
struct ReadOnly {
  template <typename T>
  __device__ __forceinline__ static T load(const T* p) {
    return __ldg(p);
  }
};

// A plain load (ld.global, L1 allocating), as the one-thread-per-slot
// body gathers x: coherent with what other blocks wrote before the last
// grid.sync(). K10 and K11 gather their SpMV input so, since their vector
// phases rewrite that input between two SpMV phases of one launch.
struct Coherent {
  template <typename T>
  __device__ __forceinline__ static T load(const T* p) {
    return *p;
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

// The values and lane-index planes (merged word, split planes and
// K2-subwin's word).
struct ValuePlanes {
  // The warp-per-sublane body takes rel from the staging (false), or from
  // load_slots_rel after the slot load (sublane_run).
  static constexpr bool kLateRel = false;
  template <class A>
  __device__ __forceinline__ static float value(const A& a, long long i) {
    return to_f32(a.vals[i]);
  }
  template <class A>
  __device__ __forceinline__ static long long lane_index(const A& a,
                                                         long long i) {
    return static_cast<long long>(a.lidx[i]);
  }
  // The warp-per-sublane body's slot loads: the four slots from slot p on
  // (p a multiple of four), one vector load of values and one of lane
  // indices.
  template <class Load, class A>
  __device__ __forceinline__ static void load_slots(const A& a, long long p,
                                                    float (&v)[4],
                                                    int (&l)[4]) {
    load_values<Load>(a.vals + p, v);
    load_lanes<Load>(a.lidx + p, l);
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

// The packed word decoded per slot: rel from slot i's own word. Only the
// old one-thread-per-slot walks in csrc/variants/ run it (K5's and
// K2-packed's, timed against the kept kernels); every kernel of the
// package reads a sublane's rel from its lane-0 word (PackedStage,
// PackedShuffle, PackedLaneZero).
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

// K5 with k columns (mat_sweep, csrc/sell_packed.cu): the packed word with
// rel read from the sublane's lane-0 word, as the JAX _unpack_plane reads
// it (w[:, 0:1]) and as the plain version does; the slice from slice_of,
// the value and lane index from the slot's own word. A warp's 32 slots lie
// in one sublane, so the lane-0 load is one broadcast address a warp.
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

// K5's staging policy on the warp-per-sublane body (csrc/sell_packed.cu).
// A sublane's rel is read from its lane-0 word only, as the JAX
// _unpack_plane reads it (w[:, 0:1]) and as the plain version does, and
// its slice from slice_of; -1 in both when either is dead. The planner
// writes one rel into all 128 words of a sublane, so on the operator's own
// planes this is the per-slot decode's result; on a plane whose lanes
// disagree with lane 0 it is the reference's. The slot loads are one
// 16-byte load of four words: value bits 16..31 (the bf16 value's float32
// bits), lane index bits 0..6.
struct PackedStage {
  static constexpr bool kLateRel = false;
  template <class A>
  __device__ __forceinline__ static void stage(const A& a, long long s,
                                               int* rel, int* slice) {
    const unsigned r =
        (static_cast<unsigned>(a.meta[s * kLanes]) >> kPackRelShift) &
        kRelDead;
    const int sl = a.slice[s];
    const bool dead = r == kRelDead || sl < 0;
    *rel = dead ? -1 : static_cast<int>(r);
    *slice = dead ? -1 : sl;
  }
  __device__ __forceinline__ static void unpack(const int4& q, float (&v)[4],
                                                int (&l)[4]) {
    const unsigned w[4] = {static_cast<unsigned>(q.x),
                           static_cast<unsigned>(q.y),
                           static_cast<unsigned>(q.z),
                           static_cast<unsigned>(q.w)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = __uint_as_float(w[i] & kPackValueMask);
      l[i] = static_cast<int>(w[i] & kPackLaneMask);
    }
  }
  template <class Load, class A>
  __device__ __forceinline__ static void load_slots(const A& a, long long p,
                                                    float (&v)[4],
                                                    int (&l)[4]) {
    unpack(Load::load(reinterpret_cast<const int4*>(a.meta + p)), v, l);
  }
};

// PackedStage without the staging load of lane 0's word: the block stages
// the slice alone (rel 0 for a live slice, -1 in both for a dead one), and
// each warp takes rel from the lane-0 word it has just loaded (thread 0's
// first word) with one __shfl_sync (load_slots_rel, sublane_run's late-rel
// hook); a dead lane-0 rel skips the sublane's products, not its load. The
// same function as PackedStage on any plane; K2-packed's policy, 2.9%
// faster than PackedStage there (csrc/sell_packed.cu).
struct PackedShuffle : PackedStage {
  static constexpr bool kLateRel = true;
  template <class A>
  __device__ __forceinline__ static void stage(const A& a, long long s,
                                               int* rel, int* slice) {
    const int sl = a.slice[s];
    *rel = sl < 0 ? -1 : 0;
    *slice = sl;
  }
  // The warp's rel, -1 when lane 0's rel is dead. All 32 lanes call it.
  template <class Load, class A>
  __device__ __forceinline__ static int load_slots_rel(const A& a,
                                                       long long p,
                                                       float (&v)[4],
                                                       int (&l)[4]) {
    const int4 q = Load::load(reinterpret_cast<const int4*>(a.meta + p));
    unpack(q, v, l);
    const unsigned r = __shfl_sync(
        kFull, (static_cast<unsigned>(q.x) >> kPackRelShift) & kRelDead, 0);
    return r == kRelDead ? -1 : static_cast<int>(r);
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

// The one-thread-per-slot N-iteration body (one cooperative launch; only
// csrc/variants/ runs it, as the walk K2 and K2-packed ran before): each
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

// ---------------------------------------------------------------------------
// One warp per sublane, under a staging policy (MergedWord: K1 and K2 on a
// resident y, K3-relsl and K2 streamed on a streamed one, and the SpMV
// phases of K10 and K11; SplitPlanes: K3-split and K2 streamed split on a streamed y, K4
// and K2 split on a resident one; SubwinWord: K2-subwin on a resident y;
// PackedStage: K5 on either; PackedShuffle: K2-packed on a resident one),
// a y policy, the plane loads' cache policy (Load) and the x gathers'
// (Gather). The
// staging policy stages a sublane (stage) and loads its slots (load_slots:
// the values and lane planes, or the packed words); a policy with kLateRel
// stages only the slice and gives rel after the slot load (load_slots_rel:
// PackedShuffle, rel from the loaded lane-0 word by a warp shuffle).
//
// Work item `item` is run r = item % runs of chunk c = item / runs: up to
// kRun consecutive sublanes of one chunk (chunks never straddle a y block
// in a streamed plan), so c, tile_base[c] and the chunk's y base come once
// per item in 32-bit index arithmetic, with one 64-bit base per run and
// 32-bit offsets inside it. The block stages the run's rel and slice ids
// in shared memory (Stage::stage: thread t loads sublane s0 + t's merged
// word and decodes it, -1 in both where rel or slice is dead; its two
// split words; or its lane-0 packed word and slice_of), then each warp
// walks every kWarps-th sublane: a dead one (rel < 0 or slice < 0) is
// skipped before any plane load; a live one costs each thread one 16-byte
// load of four values (8 bytes in bf16), one load of four lane indices (4
// bytes int8, 16 bytes int32) or one 16-byte load of four packed words,
// four gathers of x and one float4 atomic into its four consecutive rows
// (red.global.add.v4.f32, sm_90), left out when all four products are
// exactly zero. Every slot of a live sublane is multiplied, padding (v =
// 0) included, so Inf or NaN in x at a padding lane's column lands NaN in
// its row, as in the one-thread-per-slot body; padding lanes carry lane
// index 0, so their gathers read one address per sublane. The plane loads
// are streaming (the Streaming policy: read once, kept out of L1, where
// the gathered x tiles stay). The gathers go through the read-only path
// (ReadOnly, __ldg: ld.global.nc) where no thread writes x during the
// launch, which holds for every forward and N-iteration kernel; K10 and
// K11 rewrite their SpMV input between grid.sync()s, and the non-coherent
// path may then return the last step's x, so they gather with plain loads
// (Coherent).
//
// Planes must be aligned for the vector loads (values to 4 elements, lane
// indices to 4 elements, the packed plane and y to 16 bytes), and whole
// chunks: the launchers return cudaErrorMisalignedAddress or
// cudaErrorInvalidValue and launch nothing otherwise. The kernels are
// built with __launch_bounds__(kThreads, kSublaneMinBlocks): 32 registers
// a thread, eight blocks on an SM.

constexpr int kWarps = kThreads / 32;
constexpr int kRun = 64;              // sublanes per work item
constexpr int kSublaneMinBlocks = 8;  // co-resident blocks per SM
static_assert(kRun <= kThreads, "one staging load per thread");

__host__ __device__ inline int runs_per_chunk(int chunk) {
  return (chunk + kRun - 1) / kRun;
}

// y[0..3] += p in one vector atomic, unless all four products are zero.
__device__ __forceinline__ void add_rows4(float* y, const float (&p)[4]) {
  if (p[0] == 0.0f && p[1] == 0.0f && p[2] == 0.0f && p[3] == 0.0f) return;
  atomicAdd(reinterpret_cast<float4*>(y), make_float4(p[0], p[1], p[2], p[3]));
}

// All kThreads threads of the block call it with the same item; the
// products land in `out` (a.y, or one of the N-iteration body's two y
// buffers). `Load` is the plane loads' cache policy, `Gather` the x
// gathers'. A is Args, or a type derived from it that carries what its
// Stage reads beside the planes (K2-subwin's SubwinArgs,
// csrc/sell_bench.cu).
template <class Stage, class YAddr, class Load = Streaming,
          class Gather = ReadOnly, class A>
__device__ __forceinline__ void sublane_run(const A& a, float* out, int runs,
                                            int item, int* s_rel,
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
  const long long p0 = s0 * kLanes + lane4;
  float* y = out + ybase * kLanes + lane4;
  for (int j = threadIdx.x >> 5; j < n; j += kWarps) {
    int rel = s_rel[j];
    const int slice = s_slice[j];
    if (rel < 0 || slice < 0) continue;
    float v[4];
    int l[4];
    if constexpr (Stage::kLateRel) {
      rel = Stage::template load_slots_rel<Load>(a, p0 + j * kLanes, v, l);
      if (rel < 0) continue;  // the same for the whole warp
    } else {
      Stage::template load_slots<Load>(a, p0 + j * kLanes, v, l);
    }
    const auto* xt = a.x + (tile0 + rel) * kLanes;
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] = v[i] * to_f32(Gather::load(xt + l[i]));
    }
    add_rows4(y + static_cast<long long>(slice) * kLanes, p);
  }
  __syncthreads();  // the next item restages s_rel and s_slice
}

// K2-subwin's arguments (csrc/sell_bench.cu): the relsl planes (Args)
// and the sub-chain windows, stb and ssb of shape (n_chunks, split), int32.
template <typename V, typename L>
struct SubwinArgs : Args<V, L> {
  const int* stb;
  const int* ssb;
  int split;
  int sub_wt;
  int sub_nsw;
};

// K2-subwin's staging of sublane s (csrc/sell_bench.cu): its
// sub-chain h = (s mod chunk) / (chunk / split) and the window rule, once
// per sublane, on the merged word's raw fields r and sl:
//   rel_adj = r - (stb[c, h] - tile_base[c])
//   live iff 0 <= rel_adj < sub_wt and ssb[c, h] <= sl < ssb[c, h] + sub_nsw
// A live sublane stages K2's own rel and slice (its column, (tile_base[c]
// + r)·128 + lidx, equals (stb + rel_adj)·128 + lidx); every other one -1
// in both. Dead sublanes (r = 511 or the dead slice id) fall out of the
// same rule (_sub_windows keeps 511 - (stb - tile_base) outside [0,
// sub_wt), and the dead slice id lies above every slice window), so no
// separate dead check can disagree with it.
struct SubwinWord : ValuePlanes {
  template <class A>
  __device__ __forceinline__ static void stage(const A& a, long long s,
                                               int* rel, int* slice) {
    const unsigned word = static_cast<unsigned>(a.meta[s]);
    const long long c = s / a.chunk;
    const long long h = (s - c * a.chunk) / (a.chunk / a.split);
    const long long stb = a.stb[c * a.split + h];
    const long long ssb = a.ssb[c * a.split + h];
    const long long r = word & kRelDead;
    const long long sl = word >> kSliceShift;
    const long long rel_adj = r - (stb - a.tile_base[c]);
    const bool live = rel_adj >= 0 && rel_adj < a.sub_wt && sl >= ssb &&
                      sl < ssb + a.sub_nsw;
    *rel = live ? static_cast<int>(r) : -1;
    *slice = live ? static_cast<int>(sl) : -1;
  }
};

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
// Which form a kernel takes was measured (csrc/sell_bench.cu). A as in
// sublane_run.
template <class Stage, class YAddr, int YBuffers, class Load = Streaming,
          class A>
__device__ __forceinline__ void sublane_bench_sweeps(const A& a) {
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
// planes are whole chunks and the items fit a grid. A is Args or MatArgs.
template <class A>
bool sublane_items(const A& a, long long* items) {
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

// The one-thread-per-slot k-column warp walk (K5 with k columns; K1, K4
// and K2 with k columns ran it before sublane_mat_run, and the old walks in
// csrc/variants/ still do): the warp of slot i adds its live nonzero
// slots' products into Y. One thread decodes each slot (the plane
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

// ---------------------------------------------------------------------------
// The k-column body on one warp per sublane (`sublane_mat_run`: K1 and K4
// with k columns, and K2 with k columns in the N-iteration walk
// sublane_mat_bench_sweeps, csrc/sell_spmm.cu), under a staging policy
// (MergedWord or SplitPlanes), a column shape MatShape<T, W, P> and a
// resident Y.
//
// A block takes a work item of sublane_run (up to kRun sublanes of chunk c,
// blockIdx.x) and a column block (blockIdx.y: kCols = T * W * P columns
// from blockIdx.y * kCols), in three steps between __syncthreads():
//  1. Stage. Thread t < n stages sublane s0 + t's rel and its key (the
//     slice, -1 where rel or slice is dead); each warp then takes every
//     kWarps-th sublane, skips a dead one before any plane load, and each
//     thread loads four values with one vector load (16 bytes f32, 8 bf16)
//     and ballots which are nonzero: the sublane's mask of nonzero lanes,
//     four words, word w bit t = lane 4t + w.
//  2. Runs. A live sublane whose key differs from the one before it heads
//     a run of sublanes of one slice: the planner sorts sublanes by (tile,
//     slice, duplicate), so a slice's duplicate sublanes in one tile are
//     next to each other (ops/sell_plan.py). A run is also cut where the
//     sublane's index in the item is a multiple of kMatRunCap (16). Warp 0
//     ors each run's masks into the run's touched lanes and lays out its
//     units, one per touched lane, with a prefix sum.
//  3. Units. A unit is one row of Y, (the run's slice, lane l). A group of
//     T threads takes units g, g + kGroups, ...: it walks the run's
//     sublanes in plan order, and for each whose mask holds lane l loads
//     the slot's value and lane index, gathers X[col, ...] (W elements a
//     load: a float4 in f32, four bf16 in 8 bytes, or one element) and adds
//     v * x into P * W float32 registers a thread; then adds the row's sums
//     into Y once (red.global.add.v4.f32 per four columns, left out when
//     all four are zero; float atomics in the scalar form).
// So a run of d duplicate sublanes costs each touched row ceil(d / 16)
// atomics or so, not d, and a hub row's runs of up to 129 sublanes are
// units that groups walk side by side. A row's k columns are spread over
// T threads of P loads each (csrc/sell_spmm.cu, with_mat_shape): at k = 8
// in f32 one thread takes a row, two float4 (32 rows a warp step); at k =
// 256 eight threads four float4 each, in two column blocks of 128 (the
// blocks run column block by column block, which halves the X and Y rows
// in flight). Only nonzero slots are multiplied: a zero
// value (a padding lane) contributes nothing even against an Inf or NaN in
// X. The values are loaded through the read-only path (L1-allocating), so
// step 3's reloads of a nonzero slot's value and lane index hit the lines
// step 1 brought in; X is gathered the same way, in plan (tile-major)
// order across the grid, so a chunk's window of X rows is shared in L2.
//
// The vector form (W = 4) needs k % 4 == 0, X aligned to four elements and
// Y to 16 bytes; the scalar form (W = 1) takes any k. Both need the values
// plane aligned to four elements and planes of whole chunks: the launchers
// return cudaErrorMisalignedAddress or cudaErrorInvalidValue and launch
// nothing otherwise.

// The k-column kernels fit this cap of 64 registers a thread without
// spills (ptxas -v; chip_smoke.py's [regs] line), four to six blocks on an
// SM. Eight (32 registers) was up to 9% faster at k = 8 and 21-55% slower
// on gcn_arxiv (bench/bench_variants.py --kcol, variant blocks8).
constexpr int kMatMinBlocks = 4;  // co-resident blocks per SM, k columns
// A cap of 4 or 8 sublanes a unit cost up to 2.3x on gcn_arxiv's Aᵀ (its
// hub runs), 64 up to 1.6x there; 16 was within 4% of the best on every
// plan measured (variant shape, caps 4, 8, 16, 64).
constexpr int kMatRunCap = 16;    // sublanes a unit sums at most
static_assert(kRun == 64, "step 2 gives each lane of warp 0 two sublanes");

template <int T, int W, int P>
struct MatShape {
  static_assert(T >= 1 && T <= 32 && (T & (T - 1)) == 0,
                "T is a power of two up to a warp");
  static_assert(W == 1 || W == 4, "scalar or four-element columns");
  static_assert(P >= 1, "at least one pass");
  static constexpr int kT = T;
  static constexpr int kW = W;
  static constexpr int kP = P;
  static constexpr int kGroups = kThreads / T;  // units in flight a block
  static constexpr int kCols = T * W * P;       // columns of a column block
};

// A block's staging of one work item.
struct MatStage {
  int rel[kRun];
  int key[kRun];             // slice, -1 where the sublane is dead
  unsigned mask[kRun][4];    // nonzero lanes: word w, bit t = lane 4t + w
  unsigned lanes[kRun][4];   // at a run's head: the lanes the run touches
  int off[kRun + 1];         // units before each sublane
};

__device__ __forceinline__ void load_x(const float* p, float (&x)[1]) {
  x[0] = __ldg(p);
}
__device__ __forceinline__ void load_x(const __nv_bfloat16* p,
                                       float (&x)[1]) {
  x[0] = __bfloat162float(__ldg(p));
}
template <typename V>
__device__ __forceinline__ void load_x(const V* p, float (&x)[4]) {
  load_values<ReadOnly>(p, x);
}

__device__ __forceinline__ void add_row(float* y, const float (&p)[1]) {
  if (p[0] != 0.0f) atomicAdd(y, p[0]);
}
__device__ __forceinline__ void add_row(float* y, const float (&p)[4]) {
  add_rows4(y, p);
}

// All kThreads threads of the block call it with the same item and column
// block; the rows' sums land in `out` (a.out, or one of the N-iteration
// walk's two Y buffers). A unit sums at most Cap sublanes (a power of
// two): a run is cut where the sublane index within the item is a multiple
// of Cap, so a hub row's long run is several units that groups take side
// by side, not one long serial walk. Cap = 1 flushes every sublane's rows
// on their own (a variant, csrc/variants/sell_spmm_variants.cu).
template <class Stage, class Shape, int Cap = kMatRunCap, typename V,
          typename L>
__device__ __forceinline__ void sublane_mat_run(const MatArgs<V, L>& a,
                                                float* out, int runs,
                                                int item, int col0,
                                                MatStage& st) {
  constexpr int T = Shape::kT, W = Shape::kW, P = Shape::kP;
  const int c = item / runs;
  const int first = (item - c * runs) * kRun;
  const int n = min(kRun, a.chunk - first);
  const long long s0 = static_cast<long long>(c) * a.chunk + first;
  const long long tile0 = a.tile_base[c];
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < n) {
    int rel, slice;
    Stage::stage(a, s0 + threadIdx.x, &rel, &slice);
    st.rel[threadIdx.x] = rel;
    st.key[threadIdx.x] = rel < 0 || slice < 0 ? -1 : slice;
  }
  __syncthreads();
  // 1. the nonzero lanes of each live sublane
  const V* vals = a.vals + s0 * kLanes;
  for (int j = threadIdx.x >> 5; j < n; j += kWarps) {
    unsigned m[4] = {0u, 0u, 0u, 0u};
    if (st.key[j] >= 0) {
      float v[4];
      load_values<ReadOnly>(vals + j * kLanes + 4 * lane, v);
#pragma unroll
      for (int w = 0; w < 4; ++w) m[w] = __ballot_sync(kFull, v[w] != 0.0f);
    }
    if (lane == 0) {
#pragma unroll
      for (int w = 0; w < 4; ++w) st.mask[j][w] = m[w];
    }
  }
  __syncthreads();
  // 2. runs, their touched lanes and their units' offsets
  if (threadIdx.x < 32) {
    int count[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * lane + h;
      count[h] = 0;
      const int key = j < n ? st.key[j] : -1;
      if (key >= 0 && (j % Cap == 0 || st.key[j - 1] != key)) {
        unsigned u[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) u[w] = st.mask[j][w];
        for (int jj = j + 1; jj % Cap && jj < n && st.key[jj] == key; ++jj) {
#pragma unroll
          for (int w = 0; w < 4; ++w) u[w] |= st.mask[jj][w];
        }
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          st.lanes[j][w] = u[w];
          count[h] += __popc(u[w]);
        }
      }
    }
    const int pair = count[0] + count[1];
    int incl = pair;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += t;
    }
    st.off[2 * lane] = incl - pair;
    st.off[2 * lane + 1] = incl - pair + count[0];
    if (lane == 31) st.off[kRun] = incl;
  }
  __syncthreads();
  // 3. the units: one row each, its run's products summed in registers
  const int total = st.off[kRun];
  const int q = threadIdx.x % T;
  const int cols = min(Shape::kCols, a.k - col0);
  const L* lidx = a.lidx + s0 * kLanes;
  for (int u = threadIdx.x / T; u < total; u += Shape::kGroups) {
    int lo = 0, hi = kRun;  // st.off[lo] <= u < st.off[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (st.off[mid] <= u) lo = mid;
      else hi = mid;
    }
    const int j = lo;  // the run's head
    int r = u - st.off[j];
    int w = 0;
    unsigned word = st.lanes[j][0];
    while (r >= __popc(word)) {
      r -= __popc(word);
      word = st.lanes[j][++w];
    }
    for (; r > 0; --r) word &= word - 1;
    const int bit = __ffs(word) - 1;
    const int l = 4 * bit + w;
    const int key = st.key[j];
    float acc[P][W];
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int i = 0; i < W; ++i) acc[p][i] = 0.0f;
    }
    for (int jj = j; jj < n && st.key[jj] == key && (jj == j || jj % Cap);
         ++jj) {
      if (!((st.mask[jj][w] >> bit) & 1u)) continue;
      const int i = jj * kLanes + l;
      const float v = to_f32(__ldg(vals + i));
      const long long col = (tile0 + st.rel[jj]) * kLanes +
                            static_cast<long long>(__ldg(lidx + i));
      const V* xr = a.x + col * a.k + col0;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int cc = (p * T + q) * W;
        if (cc < cols) {
          float x[W];
          load_x(xr + cc, x);
#pragma unroll
          for (int e = 0; e < W; ++e) acc[p][e] += v * x[e];
        }
      }
    }
    float* yr = out + (static_cast<long long>(key) * kLanes + l) * a.k +
                col0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int cc = (p * T + q) * W;
      if (cc < cols) add_row(yr + cc, acc[p]);
    }
  }
  __syncthreads();  // a next item restages st
}

// The forward kernels' body: work item blockIdx.x, column block blockIdx.y.
template <class Stage, class Shape, int Cap = kMatRunCap, typename V,
          typename L>
__device__ __forceinline__ void sublane_mat_sweep(const MatArgs<V, L>& a) {
  __shared__ MatStage st;
  sublane_mat_run<Stage, Shape, Cap>(a, a.out, runs_per_chunk(a.chunk),
                                     blockIdx.x, blockIdx.y * Shape::kCols,
                                     st);
}

// The N-iteration body of the k-column form (K2 with k columns; one
// cooperative launch), in one of two forms as sublane_bench_sweeps: each
// iteration walks the items x column blocks pieces of work in a
// block-uniform grid-stride loop, piece w being column block w / items
// and item w % items (so the grid runs column block by column block, as
// the forward launch does), each on sublane_mat_run. YBuffers = 1: zero
// all of Y (float4 stores), grid.sync(), walk, grid.sync(). YBuffers = 2:
// Y[0] = a.out and Y[1] = a.out + n_out taken in turn, the next zeroed
// while this one is swept, one grid.sync() an iteration, the result in
// Y[(N - 1) % 2]. Zeroing all of a buffer keeps rows that no chunk visits
// at zero. n_out (NS * 128 * k) is a multiple of 4, Y 16-byte aligned and
// the pieces of work fewer than 2^31 (the launcher checks).
template <class Stage, class Shape, int YBuffers, typename V, typename L>
__device__ __forceinline__ void sublane_mat_bench_sweeps(
    const MatArgs<V, L>& a) {
  static_assert(YBuffers == 1 || YBuffers == 2, "one or two Y buffers");
  __shared__ MatStage st;
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int runs = runs_per_chunk(a.chunk);
  const int items = static_cast<int>(
      a.n_slots / (static_cast<long long>(kLanes) * a.chunk)) * runs;
  const int work = items * ((a.k + Shape::kCols - 1) / Shape::kCols);
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long n4 = a.n_out / 4;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4* y4 = reinterpret_cast<float4*>(a.out);
  if (YBuffers == 2) {
    for (long long i = tid; i < n4; i += stride) y4[i] = zero;
    grid.sync();
  }
  for (int it = 0; it < a.iterations; ++it) {
    const bool more = it + 1 < a.iterations;
    float* out = a.out;
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
    for (int w = blockIdx.x; w < work; w += gridDim.x) {
      const int cb = w / items;
      sublane_mat_run<Stage, Shape>(a, out, runs, w - cb * items,
                                    cb * Shape::kCols, st);
    }
    if (more) grid.sync();
  }
}

// The alignment a column shape's loads and atomics need: the values plane
// to four elements (step 1's vector loads); in the vector form also X to
// four elements and Y to 16 bytes (k % 4 == 0 keeps every row so).
template <class Shape, typename V, typename L>
bool mat_aligned(const MatArgs<V, L>& a) {
  const auto at = [](const void* p, size_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  if (!at(a.vals, 4 * sizeof(V))) return false;
  return Shape::kW == 1 ||
         (a.k % 4 == 0 && at(a.x, 4 * sizeof(V)) && at(a.out, 16));
}

// The k-column launches' checks: the column shape's alignment, planes of
// whole chunks and at least one sublane, at most 65,535 column blocks.
// Gives the work items and column blocks.
template <class Shape, typename V, typename L>
cudaError_t mat_work(const MatArgs<V, L>& a, long long* items,
                     long long* col_blocks) {
  if (!mat_aligned<Shape>(a)) return cudaErrorMisalignedAddress;
  if (a.k < 1 || !sublane_items(a, items)) return cudaErrorInvalidValue;
  *col_blocks = (a.k + Shape::kCols - 1) / Shape::kCols;
  return *col_blocks > 65535 ? cudaErrorInvalidValue : cudaSuccess;
}

// One block per work item and column block of the k-column body.
template <class Shape, typename V, typename L>
cudaError_t launch_mat(void (*kernel)(MatArgs<V, L>), MatArgs<V, L> a,
                       cudaStream_t stream) {
  long long items = 0, col_blocks = 0;
  cudaError_t err = mat_work<Shape>(a, &items, &col_blocks);
  if (err != cudaSuccess) return err;
  void* params[] = {&a};
  err = cudaLaunchKernel(
      reinterpret_cast<const void*>(kernel),
      dim3(static_cast<unsigned>(items), static_cast<unsigned>(col_blocks)),
      dim3(kThreads), params, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Blocks of a cooperative launch of `kernel` with `threads` threads a
// block: SMs x co-resident blocks per SM (a larger grid fails at launch, not at the
// grid.sync()).
template <class Kernel>
cudaError_t cooperative_grid(Kernel kernel, int device, int* blocks,
                             int threads = kThreads) {
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
      &per_sm, reinterpret_cast<const void*>(kernel), threads, 0);
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
