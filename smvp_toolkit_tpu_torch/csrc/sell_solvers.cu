// Fused SPD solvers for Hopper (sm_90a): a whole fixed-iteration solve in
// one cooperative launch, its SpMV phases on the bodies of sell_common.cuh
// (K10 and K11 on one warp per sublane, K9 on one thread per slot).
//
// Replaces three Pallas kernels of the JAX package:
//   sell_cg_kernel        <- ops/cg_fused.py:64 _make_cg_kernel (K9,
//                            launched :216): conjugate gradient, merged
//                            word or split planes
//   sell_chebyshev_kernel <- ops/pcg_fused.py:188 the _kernel of
//                            fused_chebyshev (K10, launched :228)
//   sell_pcg_ic0_kernel   <- ops/pcg_fused.py:343 the _kernel of
//                            fused_pcg_ic0 with _chunk_spmv_sched :66 (K11,
//                            launched :430): IC(0)-preconditioned CG with
//                            truncated-Neumann triangular sweeps
//
// What they compute, on float32 state vectors of n = T·128 entries
// (T = max(NS, CT)), x0 = 0 (the JAX recurrences, same update order):
//   K9:  r = p = b; per step: q = A·p; α = r·r / max(p·q, 1e-30);
//        x += α·p; r -= α·q; β = r'·r' / max(r·r, 1e-30); p = r + β·p.
//   K10: r = b, d = b·(1/θ); per step k: q = A·d; x += d; r -= q;
//        d = a_k·d + c_k·r, (a_k, c_k) from a host table.
//   K11: z0 = M⁻¹b, p = z0; per step: q = A·p; α = r·z / max(p·q, 1e-30);
//        x += α·p; r -= α·q; then M⁻¹r by (sweeps−1) sweeps of strict(L)
//        and (sweeps−1) of strict(L)ᵀ (the phase actions _a_end, _l_sweep,
//        _l_last, _lt_sweep, _lt_last of pcg_fused.py:368-405, invd =
//        1/diag(L)); β = r·w / max(r·z, 1e-30); p = w + β·p. The JAX grid
//        runs num_iters + 1 passes, pass 0 being the set-up (its A phase
//        meets p = 0 and changes nothing); here pass 0 starts at its
//        first L sweep, and the last pass stops after its x update, the
//        last change to x.
// Padding entries of the state stay exactly 0 (b is zero-padded, the
// planes hold no nonzero there), so the dot products need no mask.
//
// The TPU kernels keep the state in VMEM and walk the grid in order, with
// the one-hot table select and row reduce, windowed stores and a VMEM
// budget gate; none of that exists here. The state lives in device memory
// (five to seven vectors of 4.5 MB at 1.1M rows, together inside the
// 50 MB L2), and the whole grid of SMs x co-resident blocks walks each
// phase in grid-stride loops separated by grid.sync(). So the port runs the
// 1M-row class that the JAX kernels run only with SMVP_SELL_VMEM_MB raised.
//
// Scalars from reductions: each block writes its partial sum (double) to
// a per-block slot of a reduction array, grid.sync(), then every block
// sums all partials in the same order (one warp, the same shuffle tree),
// so every block holds the same α, β and r·z in registers and no global
// scalar slot is ever reused while another block may still read it. Each
// reduction array is written in one phase and read in the next, with at
// least one more grid.sync() before its next write.
//
// bf16 value mode rounds the SpMV's input vector (p, d, or the sweep
// input) to bf16, as cg_fused.py:70-71 and pcg_fused.py:80-81 round the x
// window: the phase that writes the input also writes its bf16 copy, which
// the slot body reads; the state and reductions stay float32. In float32
// mode the SpMV reads the state vector itself.
//
// K10's and K11's SpMV phases walk the plan's work items (up to kRun = 64
// sublanes of one chunk each: hpcg104's A is 212 chunks of 2048, 6,784
// items over a grid of 1,056 blocks) in a block-uniform grid-stride loop,
// each item on the warp-per-sublane body (sublane_run under MergedWord: the
// chunk's metadata once per item, the run's rel and slice staged in shared
// memory, a warp per live sublane, 16-byte plane loads, a float4 atomic
// per four rows of q). K10 walks all of them; K11 walks one range of items
// per phase (spmv_items over [lo, hi)): A's, strict(L)'s and
// strict(L)ᵀ's, whose plans are concatenated whole chunks at one chunk
// size, so tile_base[c] with the global chunk index c is each plan's own
// (hpcg104: 212, 110 and 110 chunks, 6,784 / 3,520 / 3,520 items). That
// body gathers x through the read-only path (__ldg, ld.global.nc) in every
// other kernel, which is correct only for data no thread writes during the
// launch; here the vector phases rewrite the SpMV input between SpMV
// phases (K10: d in float32, its bf16 copy xin in bfloat16; K11: xin, its
// own buffer in both modes, in _a_end, _l_sweep, _l_last, _lt_sweep and
// after _lt_last) and only a grid.sync() separates those writes from the
// next phase's gathers, so both gather with plain, coherent loads (the
// Coherent gather policy, as the one-thread-per-slot body loads x); the
// plane loads stay streaming (__ldcs: the planes are read-only for the
// whole launch).
// Before, K10 and K11 ran one thread per slot (spmv_range over slot: a
// 64-bit divide, the metadata loads and a scalar atomic per slot): K10
// 170.17 ms for 600 steps at hpcg104 against its scan loop over
// torch.sparse.mm at 111.45 ms (NVIDIA H100 80GB HBM3, 700 W,
// chip_smoke.py); on this body 78.0-78.6 ms, 0.70x that loop, and 1-2%
// slower again with the gathers through L2 only (__ldcg;
// bench/bench_variants.py --solver, same card). K11 took 132.27 ms for
// 100 steps at hpcg104 on the old walk, 1.58x its scan loop's 83.70 ms.
// K9 still runs spmv_range.
//
// Bound on this card: bytes. Each step reads the planes of every SpMV
// phase (A; K11: A + (sweeps−1)·(L + Lᵀ)) and a few state vectors; at the
// HPCG 104³ size the planes (hundreds of MB) exceed the L2 and dominate,
// while the state stays in the L2. The grid.sync()s (four per CG step,
// two per Chebyshev step, 3 + 4·(sweeps−1) per IC(0)-PCG step) add a
// fixed cost per step that is not memory traffic.
//
// C interface (ctypes): each launch function returns a cudaError_t value,
// 0 on success, from cudaGetLastError() right after the launch; the
// caller's stream is PyTorch's current stream; nothing here allocates or
// synchronises. A K10 or K11 launch whose values or lane planes are not
// aligned to four elements, or whose q is not aligned to 16 bytes, returns
// cudaErrorMisalignedAddress, and one whose planes are not whole chunks
// (or hold no sublane), or (K11) whose factor bounds slots_l0 <= slots_lt0
// <= n_slots do not fall on chunk boundaries, cudaErrorInvalidValue;
// neither launches anything.

#include <cooperative_groups.h>

#include <type_traits>

#include "sell_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace sell;

// Co-resident blocks per SM the compiler must leave room for: 8 blocks of
// 256 threads fill an SM, and cap a thread at 32 registers. Left to
// itself the compiler gives these kernels 64-96 registers, so an SM holds
// 2-4 blocks and the SpMV phases keep too few gathers in flight (PERF.md
// section 6). The cap spills a few hundred bytes in the reduction phases,
// which run once per phase, not once per slot.
constexpr int kSolverMinBlocks = 8;

// Kernel ids of sell_solver_blocks, shared with ops/cg_fused.py.
enum Solver : int { kCg = 0, kChebyshev = 1, kPcgIc0 = 2 };

// Everything a solver kernel reads. spmv holds the planes, spmv.x the SpMV
// input (xin: bf16 copy, or the float32 state vector itself) and spmv.y
// the SpMV output q.
template <typename V, typename L>
struct SolverArgs {
  Args<V, L> spmv;
  const float* b;
  const float* coef;     // K10: (a_k, c_k) pairs, 2·iterations floats
  const float* invd;     // K11: 1 / diag(L)
  float* x;
  float* r;
  float* p;              // K9, K11: search direction; K10: d
  float* z;              // K11: the forward sweep's result, then w
  V* xin;                // SpMV input (p or d copy; K11: the sweep input)
  double* part;          // 2 · part_cap per-block partial sums
  long long part_cap;    // blocks the reduction arrays hold
  long long n;           // state length T·128
  long long slots_l0;    // K11: first slot of strict(L), of strict(L)ᵀ,
  long long slots_lt0;   //      and the end of all slots
  long long slots_end;
  int iterations;
  int sweeps;            // K11
  float inv_theta;       // K10
};

__device__ __forceinline__ void store(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16(v);
}

// The SpMV input's copy, where it is not the state vector itself.
template <typename V>
__device__ __forceinline__ void store_in(V* xin, long long i, float v) {
  if constexpr (!std::is_same<V, float>::value) store(xin, i, v);
}

// Writes this block's share of a dot product into part[blockIdx.x]. All
// threads of the block call it.
__device__ __forceinline__ void block_partial(double v, double* part) {
  __shared__ double sh[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? sh[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
    if (lane == 0) part[blockIdx.x] = v;
  }
  __syncthreads();
}

// The sum of all blocks' partials, the same in every block (fixed order).
// All threads of the block call it, after a grid.sync().
__device__ __forceinline__ double grid_total(const double* part) {
  __shared__ double total;
  if (threadIdx.x < 32) {
    double v = 0.0;
    for (unsigned j = threadIdx.x; j < gridDim.x; j += 32) v += part[j];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
    if (threadIdx.x == 0) total = v;
  }
  __syncthreads();
  const double t = total;
  __syncthreads();
  return t;
}

// q += A·xin over the slots [lo, hi), one thread per slot: K9's SpMV
// phase, and the old walk of K10 and K11 (csrc/variants/).
template <class Decode, typename V, typename L>
__device__ __forceinline__ void spmv_range(const Args<V, L>& a, long long lo,
                                           long long hi, long long tid,
                                           long long stride) {
  for (long long i = lo + tid; i < hi; i += stride) {
    slot<Decode, ResidentY>(a, i);
  }
}

template <class Decode, typename V, typename L>
__device__ void cg_solve(const SolverArgs<V, L>& a) {
  cg::grid_group grid = cg::this_grid();
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  double* part_pq = a.part;
  double* part_rr = a.part + a.part_cap;
  double acc = 0.0;
  for (long long i = tid; i < a.n; i += stride) {
    const float bi = a.b[i];
    a.x[i] = 0.0f;
    a.r[i] = bi;
    a.p[i] = bi;
    a.spmv.y[i] = 0.0f;
    store_in(a.xin, i, bi);
    acc += static_cast<double>(bi * bi);
  }
  block_partial(acc, part_rr);
  grid.sync();
  float rs = static_cast<float>(grid_total(part_rr));
  for (int it = 0; it < a.iterations; ++it) {
    spmv_range<Decode>(a.spmv, 0, a.spmv.n_slots, tid, stride);
    grid.sync();
    acc = 0.0;
    for (long long i = tid; i < a.n; i += stride) {
      acc += static_cast<double>(a.p[i] * a.spmv.y[i]);
    }
    block_partial(acc, part_pq);
    grid.sync();
    const float pq = static_cast<float>(grid_total(part_pq));
    const float alpha = rs / fmaxf(pq, 1e-30f);
    acc = 0.0;
    for (long long i = tid; i < a.n; i += stride) {
      const float q = a.spmv.y[i];
      a.x[i] += alpha * a.p[i];
      const float r = a.r[i] - alpha * q;
      a.r[i] = r;
      a.spmv.y[i] = 0.0f;
      acc += static_cast<double>(r * r);
    }
    block_partial(acc, part_rr);
    grid.sync();
    const float rs2 = static_cast<float>(grid_total(part_rr));
    const float beta = rs2 / fmaxf(rs, 1e-30f);
    for (long long i = tid; i < a.n; i += stride) {
      const float p = a.r[i] + beta * a.p[i];
      a.p[i] = p;
      store_in(a.xin, i, p);
    }
    rs = rs2;
    grid.sync();
  }
}

template <typename V, typename L>
__global__ void __launch_bounds__(kThreads, kSolverMinBlocks)
    sell_cg_kernel(const SolverArgs<V, L> a) {
  cg_solve<MergedWord>(a);
}

template <typename V, typename L>
__global__ void __launch_bounds__(kThreads, kSolverMinBlocks)
    sell_cg_split_kernel(const SolverArgs<V, L> a) {
  cg_solve<SplitPlanes>(a);
}

// q += A·xin over the work items [lo, hi) of the plan in a block-uniform
// grid-stride loop (sublane_run has __syncthreads()), each on the
// warp-per-sublane body, the gathers of xin under Gather.
template <class Gather, typename V, typename L>
__device__ __forceinline__ void spmv_items(const Args<V, L>& a, int lo,
                                           int hi) {
  __shared__ int s_rel[kRun], s_slice[kRun];
  const int runs = runs_per_chunk(a.chunk);
  for (int item = lo + blockIdx.x; item < hi; item += gridDim.x) {
    sublane_run<MergedWord, ResidentY, Streaming, Gather>(a, a.y, runs, item,
                                                          s_rel, s_slice);
  }
}

// The work items before slot `slots`, a chunk boundary (the launch checks
// every bound a phase is given).
template <typename V, typename L>
__device__ __forceinline__ int items_before(const Args<V, L>& a,
                                            long long slots) {
  return static_cast<int>(slots / (static_cast<long long>(kLanes) *
                                   a.chunk)) * runs_per_chunk(a.chunk);
}

// The SpMV phase of K10 and K11 over the slots [lo, hi) (whole chunks): the
// work items there, the gathers of xin coherent (see above). A phase
// policy's run(a, lo, hi, tid, stride) adds the slots [lo, hi) of a's
// planes times xin into q; the one-thread-per-slot phase and an
// L2-only-gather phase are variants (csrc/variants/sell_solver_variants.cu).
struct SublanePhase {
  template <typename V, typename L>
  __device__ __forceinline__ static void run(const Args<V, L>& a,
                                             long long lo, long long hi,
                                             long long, long long) {
    spmv_items<Coherent>(a, items_before(a, lo), items_before(a, hi));
  }
};

// K10's solve with its SpMV phase on Phase (SublanePhase; the old
// one-thread-per-slot phase is a variant in
// csrc/variants/sell_solver_variants.cu) over all slots.
template <class Phase, typename V, typename L>
__device__ __forceinline__ void chebyshev_solve(const SolverArgs<V, L>& a) {
  cg::grid_group grid = cg::this_grid();
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = tid; i < a.n; i += stride) {
    const float bi = a.b[i];
    const float d = bi * a.inv_theta;
    a.x[i] = 0.0f;
    a.r[i] = bi;
    a.p[i] = d;
    a.spmv.y[i] = 0.0f;
    store_in(a.xin, i, d);
  }
  grid.sync();
  for (int it = 0; it < a.iterations; ++it) {
    Phase::run(a.spmv, 0, a.spmv.n_slots, tid, stride);
    grid.sync();
    const float ak = a.coef[2 * it], ck = a.coef[2 * it + 1];
    for (long long i = tid; i < a.n; i += stride) {
      const float d = a.p[i];
      a.x[i] += d;
      const float r = a.r[i] - a.spmv.y[i];
      a.r[i] = r;
      a.spmv.y[i] = 0.0f;
      const float dn = ak * d + ck * r;
      a.p[i] = dn;
      store_in(a.xin, i, dn);
    }
    grid.sync();
  }
}

template <typename V, typename L>
__global__ void __launch_bounds__(kThreads, kSolverMinBlocks)
    sell_chebyshev_kernel(const SolverArgs<V, L> a) {
  chebyshev_solve<SublanePhase>(a);
}

// K11's solve with its three SpMV phases on Phase: A over the slots [0,
// slots_l0), strict(L) over [slots_l0, slots_lt0), strict(L)ᵀ over
// [slots_lt0, n_slots).
template <class Phase, typename V, typename L>
__device__ __forceinline__ void pcg_ic0_solve(const SolverArgs<V, L>& a) {
  cg::grid_group grid = cg::this_grid();
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  double* part_pq = a.part;
  double* part_rz = a.part + a.part_cap;
  float* q = a.spmv.y;
  // Pass 0's set-up: x = 0, r = b, p = 0; its A phase (p = 0) is skipped
  // and _a_end leaves the first sweep's input invd·r.
  for (long long i = tid; i < a.n; i += stride) {
    const float bi = a.b[i];
    a.x[i] = 0.0f;
    a.r[i] = bi;
    a.p[i] = 0.0f;
    q[i] = 0.0f;
    store(a.xin, i, a.invd[i] * bi);
  }
  grid.sync();
  float rz = 1.0f;
  for (int pass = 0;; ++pass) {
    if (pass > 0) {
      Phase::run(a.spmv, 0, a.slots_l0, tid, stride);
      grid.sync();
      double acc = 0.0;
      for (long long i = tid; i < a.n; i += stride) {
        acc += static_cast<double>(a.p[i] * q[i]);
      }
      block_partial(acc, part_pq);
      grid.sync();
      const float pq = static_cast<float>(grid_total(part_pq));
      const float alpha = rz / fmaxf(pq, 1e-30f);
      for (long long i = tid; i < a.n; i += stride) {  // _a_end
        a.x[i] += alpha * a.p[i];
        const float r = a.r[i] - alpha * q[i];
        a.r[i] = r;
        q[i] = 0.0f;
        store(a.xin, i, a.invd[i] * r);
      }
      grid.sync();
    }
    if (pass == a.iterations) break;
    for (int s = 0; s < a.sweeps - 1; ++s) {
      Phase::run(a.spmv, a.slots_l0, a.slots_lt0, tid, stride);
      grid.sync();
      const bool last = s == a.sweeps - 2;
      for (long long i = tid; i < a.n; i += stride) {
        const float v = a.invd[i] * (a.r[i] - q[i]);
        q[i] = 0.0f;
        if (last) {  // _l_last
          a.z[i] = v;
          store(a.xin, i, a.invd[i] * v);
        } else {  // _l_sweep
          store(a.xin, i, v);
        }
      }
      grid.sync();
    }
    for (int s = 0; s < a.sweeps - 1; ++s) {
      Phase::run(a.spmv, a.slots_lt0, a.slots_end, tid, stride);
      grid.sync();
      if (s < a.sweeps - 2) {  // _lt_sweep
        for (long long i = tid; i < a.n; i += stride) {
          store(a.xin, i, a.invd[i] * (a.z[i] - q[i]));
          q[i] = 0.0f;
        }
        grid.sync();
        continue;
      }
      // _lt_last: w = invd·(z − q) (kept in z), r·w, then p = w + β·p.
      double acc = 0.0;
      for (long long i = tid; i < a.n; i += stride) {
        const float w = a.invd[i] * (a.z[i] - q[i]);
        a.z[i] = w;
        q[i] = 0.0f;
        acc += static_cast<double>(a.r[i] * w);
      }
      block_partial(acc, part_rz);
      grid.sync();
      const float rz_new = static_cast<float>(grid_total(part_rz));
      const float beta = pass == 0 ? 0.0f : rz_new / fmaxf(rz, 1e-30f);
      for (long long i = tid; i < a.n; i += stride) {
        const float p = a.z[i] + beta * a.p[i];
        a.p[i] = p;
        store(a.xin, i, p);
      }
      rz = rz_new;
      grid.sync();
    }
  }
}

template <typename V, typename L>
__global__ void __launch_bounds__(kThreads, kSolverMinBlocks)
    sell_pcg_ic0_kernel(const SolverArgs<V, L> a) {
  pcg_ic0_solve<SublanePhase>(a);
}

template <typename V, typename L>
using Kernel = void (*)(SolverArgs<V, L>);

template <typename V, typename L>
Kernel<V, L> solver_kernel(int solver, int route) {
  switch (solver) {
    case kCg:
      if (route == kRelsl) return sell_cg_kernel<V, L>;
      if (route == kSplit) return sell_cg_split_kernel<V, L>;
      return nullptr;
    case kChebyshev:
      return route == kRelsl ? sell_chebyshev_kernel<V, L> : nullptr;
    case kPcgIc0:
      return route == kRelsl ? sell_pcg_ic0_kernel<V, L> : nullptr;
    default:
      return nullptr;
  }
}

// The warp-per-sublane SpMV phases' checks (K10, K11): planes aligned for
// the vector loads and q for the float4 atomics, whole chunks of at least
// one sublane, and K11's factor bounds 0 <= slots_l0 <= slots_lt0 <=
// n_slots on chunk boundaries (slots_l0 = slots_lt0 = n_slots for K10).
template <typename V, typename L>
cudaError_t sublane_phase_checks(const SolverArgs<V, L>& a) {
  if (!sublane_aligned(a.spmv)) return cudaErrorMisalignedAddress;
  long long items = 0;
  if (!sublane_items(a.spmv, &items)) return cudaErrorInvalidValue;
  const long long chunk_slots = static_cast<long long>(kLanes) * a.spmv.chunk;
  const bool bounds = 0 <= a.slots_l0 && a.slots_l0 <= a.slots_lt0 &&
                      a.slots_lt0 <= a.slots_end &&
                      a.slots_l0 % chunk_slots == 0 &&
                      a.slots_lt0 % chunk_slots == 0;
  return bounds ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename V, typename L>
cudaError_t launch_solver(int solver, int route, SolverArgs<V, L> a,
                          int device, cudaStream_t stream) {
  Kernel<V, L> kernel = solver_kernel<V, L>(solver, route);
  if (kernel == nullptr || a.iterations < 0 || a.n % kLanes ||
      (route == kSplit && a.spmv.slice == nullptr) ||
      (solver == kChebyshev && a.iterations > 0 && a.coef == nullptr) ||
      (solver == kPcgIc0 && (a.invd == nullptr || a.z == nullptr ||
                             a.sweeps < 2))) {
    return cudaErrorInvalidValue;
  }
  if (solver != kCg) {
    const cudaError_t err = sublane_phase_checks(a);
    if (err != cudaSuccess) return err;
  }
  int blocks = 0;
  cudaError_t err = cooperative_grid(kernel, device, &blocks);
  if (err != cudaSuccess) return err;
  if (solver != kChebyshev && blocks > a.part_cap) return cudaErrorInvalidValue;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(blocks), dim3(kThreads), params, 0,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// A solve's SolverArgs from sell_solver_launch's arguments (after solver
// and route), handed to fn(a) for the value and lane-index types: fn is
// launch_solver there, a variant's launcher in
// csrc/variants/sell_solver_variants.cu.
template <class Fn>
cudaError_t with_solver_args(
    const void* vals, const void* lidx, const void* meta, const void* slice,
    const void* tile_base, const void* b, const void* coef, const void* invd,
    void* x, void* r, void* p, void* q, void* z, void* xin, void* part,
    long long part_cap, long long n_slots, long long slots_l0,
    long long slots_lt0, long long n, int chunk, int iterations, int sweeps,
    float inv_theta, int value_kind, int lidx_kind, Fn&& fn) {
  return sell::with_types(value_kind, lidx_kind, [&](auto v, auto l) {
    using V = typename decltype(v)::type;
    using L = typename decltype(l)::type;
    SolverArgs<V, L> a{};
    a.spmv = sell::make_args<V, L>(vals, lidx, meta, slice, tile_base,
                                   nullptr, xin, q, n_slots, n, chunk, 0, 0);
    a.b = static_cast<const float*>(b);
    a.coef = static_cast<const float*>(coef);
    a.invd = static_cast<const float*>(invd);
    a.x = static_cast<float*>(x);
    a.r = static_cast<float*>(r);
    a.p = static_cast<float*>(p);
    a.z = static_cast<float*>(z);
    a.xin = static_cast<V*>(xin);
    a.part = static_cast<double*>(part);
    a.part_cap = part_cap;
    a.n = n;
    a.slots_l0 = slots_l0;
    a.slots_lt0 = slots_lt0;
    a.slots_end = n_slots;
    a.iterations = iterations;
    a.sweeps = sweeps;
    a.inv_theta = inv_theta;
    return fn(a);
  });
}

}  // namespace

// One solve in one cooperative launch. solver: 0 = CG (K9), 1 = Chebyshev
// (K10), 2 = IC(0)-PCG (K11); route: 0 = merged word, 3 = split planes
// (K9 only). The planes as sell_spmv_launch takes them (K11: A, strict(L)
// and strict(L)ᵀ concatenated, the factors' slots from slots_l0 and
// slots_lt0 up to n_slots). b, x, r, p (K10: d), q, z (K11), invd (K11):
// float32 of n = T·128 entries; coef (K10): 2·iterations floats; xin: the
// SpMV input in the value type (float32 mode: p, d, or K11's sweep input
// buffer); part: 2·part_cap doubles (K9, K11).
extern "C" int sell_solver_launch(
    int solver, int route, const void* vals, const void* lidx,
    const void* meta, const void* slice, const void* tile_base,
    const void* b, const void* coef, const void* invd, void* x, void* r,
    void* p, void* q, void* z, void* xin, void* part, long long part_cap,
    long long n_slots, long long slots_l0, long long slots_lt0, long long n,
    int chunk, int iterations, int sweeps, float inv_theta, int value_kind,
    int lidx_kind, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = with_solver_args(
      vals, lidx, meta, slice, tile_base, b, coef, invd, x, r, p, q, z, xin,
      part, part_cap, n_slots, slots_l0, slots_lt0, n, chunk, iterations,
      sweeps, inv_theta, value_kind, lidx_kind,
      [&](auto a) { return launch_solver(solver, route, a, device, st); });
  return static_cast<int>(err);
}

// Blocks of one launch of this solver and route on this device (SMs x
// co-resident blocks): the wrapper sizes the reduction arrays with it.
extern "C" int sell_solver_blocks(int solver, int route, int value_kind,
                                  int lidx_kind, int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = sell::with_types(value_kind, lidx_kind, [&](auto v, auto l) {
    using V = typename decltype(v)::type;
    using L = typename decltype(l)::type;
    return cooperative_grid(solver_kernel<V, L>(solver, route), device,
                            blocks);
  });
  return static_cast<int>(err);
}
