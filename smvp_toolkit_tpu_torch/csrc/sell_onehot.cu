// SELL-T1 one-hot kernel for Hopper (sm_90a): y = A·x from the plan's
// DENSE one-hot operands (K6).
//
// Replaces _make_sell_kernel_onehot of the JAX package's ops/spmv_pallas.py
// (launched at :1369 under SMVP_SELL_COMPAT=1, resident y, k = 1). That
// kernel takes dense operands built outside it (:1337-1367) so that no
// compact one-hot generator is needed, and computes per chunk c
//   table = OHT_c · xw_c                    (chunk, 128)
//   g[s, l] = table[s, lidx[s, l]]
//   y += SEG_c · (vals ∘ g)                 (NS, 128)
// with
//   xw   (n_chunks, WT, 128) float32  the x tiles of each chunk's window
//   vals (S, 128) float32             (bf16 values cast to float32 first)
//   lidx (S, 128) int32
//   oht  (n_chunks, chunk, WT) float32, 1 at (s, rel_tile[s])
//   seg  (n_chunks, NS, chunk) float32, 1 at (slice_of[s], s)
// This kernel computes the same products and sums from the same operands,
// and takes every sublane's tile and slice from oht and seg, not from the
// compact planes: a wrong dense operand shows in y.
//
// Design: one warp per output row slice n (y[n, 0:128], four lanes per
// thread), so y is written once, with no atomics, and the sum runs in a
// fixed order (chunk, then sublane): the result does not change from run
// to run. The warp streams row n of every chunk's SEG_c (chunk contiguous
// floats, kSegLoads coalesced loads in flight per thread) and ballots its
// nonzero entries. For each nonzero w = SEG_c[n, s] it reads the sublane's
// oht row (WT floats, coalesced, ballot), and for each nonzero o =
// OHT_c[s, t] gathers o·xw_c[t, lidx[s, l]] into g[l]; then
// acc[l] += w · (vals[s, l] · g[l]). The zeros of a one-hot row that was
// read are skipped, so the work is the dense planes' bytes plus the live
// sublanes' table rows, vals and lidx, not the dense products.
//
// Bound on this card: bytes. The dense operands are S·(WT + NS)·4 bytes
// beyond the compact planes (the seg operand alone is 5.9 GB on the 10M-nnz
// smoke plan), which every launch reads once; the dense products
// (2·S·128·(WT + NS) flops) would take longer at the float32 rate, but the
// kernel skips the zeros and does about 4 flops per live slot.
//
// C interface (ctypes) as in sell_spmv.cu: the launch returns a
// cudaError_t value, 0 on success, from cudaGetLastError() right after the
// launch; the stream is PyTorch's current stream; nothing here allocates
// or synchronises. The kernel writes all of y (NS·128 floats).

#include "sell_common.cuh"

namespace {

using sell::kFull;
using sell::kLanes;
using sell::kThreads;

constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kLanesPerThread = kLanes / 32;  // y lanes a thread holds
constexpr int kSegLoads = 8;  // seg entries a thread loads per step

struct OnehotArgs {
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
__device__ __forceinline__ void add_sublane(const OnehotArgs& a, long long c,
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
    sell_onehot_kernel(const OnehotArgs a) {
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

}  // namespace

// y (ns·128 float32, fully written) from the dense operands above.
extern "C" int sell_onehot_launch(const void* xw, const void* vals,
                                  const void* lidx, const void* oht,
                                  const void* seg, void* y, int n_chunks,
                                  int chunk, int wt, int ns, int device,
                                  void* stream) {
  if (n_chunks < 1 || chunk < 1 || wt < 1 || ns < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const OnehotArgs a{static_cast<const float*>(xw),
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
  sell_onehot_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
