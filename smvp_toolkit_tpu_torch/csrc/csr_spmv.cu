// Merge-path CSR SpMV for Hopper (sm_90a): K12, csr_merge_spmv_kernel.
//
// Replaces no kernel of the JAX package. The TPU has no fast gather, so the
// JAX operator runs every matrix on its SELL planes, whose one-hot MXU
// table select needs a (128-row slice, 128-column tile) cell per sublane.
// The card gathers x at any address, so a matrix whose nonzeros scatter
// over the tiles (a permuted power-law graph: one 128-slot sublane per
// nonzero, about 500 bytes moved a nonzero on kron20) can be read as its
// nonzeros alone: 4 bytes of column and 2 or 4 of value each
// (ops/csr_merge.py, SellSpMV.__call__ takes this route where the card's
// cost model prices it at most half the plan's, autotune.takes_csr).
//
// The design (Merrill and Garland, "Merge-based Parallel Sparse
// Matrix-Vector Multiplication", SC'16). The rows' ends and the nonzeros
// are merged into one path of nrows + nnz items; each warp takes an equal
// share of kWarpPath items, starting from a (row, nonzero) coordinate that
// the wrapper precomputed (csr_merge.merge_coords), so a row of any length
// (a hub of 64,467 nonzeros) and a run of empty rows cost the same per
// item. A warp
//   1. streams its nonzeros' columns and values with 16-byte loads
//      (bf16 values 8 bytes) from the aligned word at or below its first
//      nonzero, all loads of a lane issued before their gathers, gathers x
//      through the read-only path and keeps the float32 products in shared
//      memory;
//   2. stages the ends of its rows in shared memory;
//   3. gives each lane kItems consecutive items of its share (a merge-path
//      search in shared memory) and walks them in order: a lane sums each
//      row that starts and ends inside its items and stores it;
//   4. adds each lane's first row end to the carries of the lanes before
//      it that lie in the same row (a segmented inclusive scan of the
//      carries by warp shuffles) and stores it, or, where the row began in
//      an earlier warp, adds it with one atomicAdd;
//   5. adds its last carry, a row that the next warp ends, with one
//      atomicAdd.
// A row wholly inside one warp's share is stored by that warp alone; a row
// cut by a share's edge takes one atomicAdd from each warp that holds part
// of it, into a y that the wrapper zeroes. Products accumulate in float32
// in both value types. The atomics make the last bits of a cut row vary
// between launches; every other row is summed in a fixed order.
//
// Bound on this card: bytes. A launch must read each nonzero's column and
// value once (nnz * (4 + value bytes)), the row pointer, x and write y;
// the merge coordinates add 8 bytes per warp (32 * kItems path items).
// x's gathers hit L2 where x fits it (4 MiB at kron20). The arithmetic, 2
// flops per nonzero, is far below the card's rate. On kron20 the launch
// takes as long with bf16 values as with float32 ones (0.266 / 0.269 ms,
// 22-29% of the byte bound): what binds it is the 31.4M gathers of x, not
// the bytes streamed.
//
// Chosen on the H100 (NVIDIA H100 80GB HBM3, 700 W; kron20, eight runs
// of five seeds in two calls): 4 items a lane took 0.980-0.987x the time
// of 8 (a warp's share of 128 items, two 16-byte loads a lane, 40-47
// registers), 16 items 1.05x; more blocks per SM (launch bounds of 6 or
// 8 blocks, 32-40 registers) and 2 items gained nothing, and a preferred
// carveout of 0% or 100% shared memory took 1.8x and 1.25x.
//
// C interface (ctypes): csr_merge_spmv_launch returns a cudaError_t value,
// 0 on success, from cudaGetLastError() right after the launch. Pointers
// and the stream come in as void*. The stream is PyTorch's current stream;
// nothing here allocates or synchronises. Columns, values or coordinates
// not aligned for the vector loads return cudaErrorMisalignedAddress, no
// warp, or coordinates cut at another share than kWarpPath items,
// cudaErrorInvalidValue; neither launches anything. The column and
// value planes hold nnz rounded up to four elements (the wrapper pads them
// with zeros), so no vector load passes their end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kItems = 4;                // path items a lane
constexpr int kWarpPath = 32 * kItems;   // path items a warp
constexpr int kWarps = 8;                // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 4;
// 16-byte loads a lane: a share's nonzeros from the aligned word below.
constexpr int kLoads = (kWarpPath + 3 + 127) / 128;
constexpr unsigned kFull = 0xffffffffu;

// Four values, streamed (read once): float32 from a 16-byte load, bfloat16
// from an 8-byte one (bf16 bits are the high half of the same float32).
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[4]) {
  const uint2 q = __ldcs(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}

// One x word as float32, through the read-only path.
__device__ __forceinline__ float gather(const float* x, int c) {
  return __ldg(x + c);
}
__device__ __forceinline__ float gather(const __nv_bfloat16* x, int c) {
  return __uint_as_float(
      static_cast<unsigned>(
          __ldg(reinterpret_cast<const unsigned short*>(x) + c))
      << 16);
}

template <typename V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    csr_merge_spmv_kernel(const int* __restrict__ row_ptr,
                          const int* __restrict__ cols,
                          const V* __restrict__ vals,
                          const int2* __restrict__ coords,
                          const V* __restrict__ x, float* __restrict__ y,
                          int n_warps) {
  __shared__ float s_prod[kWarps][kWarpPath];
  __shared__ int s_end[kWarps][kWarpPath];
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int w = blockIdx.x * kWarps + wib;
  if (w >= n_warps) return;  // whole warps leave; no block barrier follows
  const int2 c0 = __ldg(coords + w);
  const int2 c1 = __ldg(coords + w + 1);
  const int row0 = c0.x, y0 = c0.y;
  const int nr = c1.x - row0;  // rows that end in this share
  const int nn = c1.y - y0;    // nonzeros of this share
  float* prod = s_prod[wib];
  int* ends = s_end[wib];

  // 1. The share's products: every load first, then the gathers.
  const int first = (y0 & ~3) + 4 * lane;
  int4 c[kLoads];
  float v[kLoads][4];
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int i = first + 128 * u;
    if (i < c1.y) {
      c[u] = __ldcs(reinterpret_cast<const int4*>(cols + i));
      load4(vals + i, v[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int j = first + 128 * u - y0;
    if (j < nn) {
      const int cc[4] = {c[u].x, c[u].y, c[u].z, c[u].w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (j + k >= 0 && j + k < nn) {
          prod[j + k] = v[u][k] * gather(x, cc[k]);
        }
      }
    }
  }
  // 2. The ends of the share's rows, in the share's nonzero coordinates.
  for (int i = lane; i < nr; i += 32) {
    ends[i] = __ldg(row_ptr + row0 + 1 + i) - y0;
  }
  __syncwarp();

  // 3. The lane's items: the merge-path search, then the walk.
  const int len = nr + nn;
  const int d = min(lane * kItems, len);
  int lo = max(0, d - nn), hi = min(d, nr);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ends[mid] + mid < d) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int tx = lo, ty = d - lo;
  const int n_items = min(kItems, len - d);
  float run = 0.0f, head = 0.0f;
  int head_row = -1;  // the lane's first row end, in the share's rows
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (k < n_items) {
      if (tx < nr && ends[tx] <= ty) {  // row row0 + tx ends
        if (head_row < 0) {
          head = run;
          head_row = tx;
        } else {
          y[row0 + tx] = run;  // begun and ended in this lane
        }
        run = 0.0f;
        ++tx;
      } else {
        run += prod[ty];
        ++ty;
      }
    }
  }

  // 4. The carries: a segmented inclusive scan, a segment starting at
  // each lane that ended a row.
  float carry = run;
  int flag = head_row >= 0;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(kFull, carry, off);
    const int up_flag = __shfl_up_sync(kFull, flag, off);
    if (lane >= off) {
      if (!flag) carry += up;
      flag |= up_flag;
    }
  }
  const float before = __shfl_up_sync(kFull, carry, 1);
  if (head_row >= 0) {
    const float total = head + (lane ? before : 0.0f);
    float* out = y + row0 + head_row;
    if (head_row == 0 && __ldg(row_ptr + row0) < y0) {
      atomicAdd(out, total);  // the row began in an earlier warp
    } else {
      *out = total;
    }
  }
  // 5. The row the next warp ends, where this warp holds part of it.
  if (lane == 31 && c1.y > __ldg(row_ptr + c1.x)) atomicAdd(y + c1.x, carry);
}

template <typename V>
cudaError_t launch_csr(const void* row_ptr, const void* cols,
                       const void* vals, const void* coords, const void* x,
                       void* y, int n_warps, int warp_path,
                       cudaStream_t stream) {
  if (n_warps < 1 || warp_path != kWarpPath) return cudaErrorInvalidValue;
  const auto at = [](const void* p, size_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  if (!at(cols, 16) || !at(vals, 4 * sizeof(V)) || !at(coords, 8)) {
    return cudaErrorMisalignedAddress;
  }
  const unsigned blocks = static_cast<unsigned>(
      (static_cast<long long>(n_warps) + kWarps - 1) / kWarps);
  csr_merge_spmv_kernel<V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(cols),
      static_cast<const V*>(vals), static_cast<const int2*>(coords),
      static_cast<const V*>(x), static_cast<float*>(y), n_warps);
  return cudaGetLastError();
}

}  // namespace

// y (nrows float32, zeroed by the caller) += A·x over the CSR planes and
// the merge coordinates of n_warps shares of warp_path items each (the
// last may be shorter), which must be kWarpPath. value_kind 0 = float32,
// 1 = bfloat16 (vals and x).
extern "C" int csr_merge_spmv_launch(const void* row_ptr, const void* cols,
                                     const void* vals, const void* coords,
                                     const void* x, void* y, int n_warps,
                                     int warp_path, int value_kind,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  if (value_kind == 0) {
    err = launch_csr<float>(row_ptr, cols, vals, coords, x, y, n_warps,
                            warp_path, s);
  } else if (value_kind == 1) {
    err = launch_csr<__nv_bfloat16>(row_ptr, cols, vals, coords, x, y,
                                    n_warps, warp_path, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* csr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
