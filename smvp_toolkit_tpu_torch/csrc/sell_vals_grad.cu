// SELL-T1 values-gradient kernel for Hopper (sm_90a): the cotangent of the
// SpMM Y = A(vals)·X with respect to the values plane, for output
// cotangent G.
//
// Replaces _make_vals_grad_kernel of the JAX package's ops/spmv_pallas.py
// (K7, via _sell_vals_grad_call :998, launched :1028 with a window stack
// and :1051 with a resident x), for every k >= 1:
//   sell_vals_grad_kernel
//     out[s, l] = sum over j < k of G[row(s,l), j] * X[col(s,l), j]
// on all 128 lanes of every live sublane: a padding lane of a live sublane
// carries its true partial (its lane index is 0, so it reads the first
// column of its tile), as the TPU kernel's does. A dead sublane (rel or
// slice dead, sell_common.cuh) is exactly 0. The values plane itself is
// not read: SpMM is bilinear. The TPU kernel selects both factors with
// one-hot MXU products because the TPU has no fast gather; here they are
// plain gathers of X and G rows. X is read in its storage type (float32 or
// bfloat16), G is float32, products and sums float32.
//
// Design: one thread per slot decodes its slot; the 32 slots of a warp lie
// in one sublane, so the warp is all live or all dead. A live warp walks
// its 32 slots in turn: the slot's X row and G row are broadcast with
// __shfl_sync, the lanes take the k columns 32 at a time (coalesced reads
// of both rows), each lane sums its columns in ascending order and a
// butterfly of __shfl_xor_sync adds the 32 partial sums; the slot's own
// lane keeps the total and every lane stores one output word (coalesced).
// The order of the sum is fixed, so the result is the same on every run;
// it differs from the ascending sum over j in the last bits.
//
// Bound on this card: bytes. It reads the lane-index plane and the
// per-sublane metadata once, an X row and a G row per slot (k values
// each; the G rows of one sublane are contiguous, and a padding lane's X
// row is its tile's first), and writes the (S, 128) plane once. The
// arithmetic is 2·k flops per slot.
//
// C interface (ctypes) as in sell_spmm.cu; every output word is written.

#include "sell_common.cuh"

namespace {

using namespace sell;

template <class Decode, typename V, typename L>
__device__ __forceinline__ void vals_grad(const MatArgs<V, L>& a) {
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

template <class Decode, typename V, typename L>
__global__ void __launch_bounds__(kThreads)
    sell_vals_grad_kernel(const MatArgs<V, L> a) {
  vals_grad<Decode>(a);
}

template <typename V, typename L>
cudaError_t launch_vals_grad(int route, MatArgs<V, L> a,
                             cudaStream_t stream) {
  void (*kernel)(MatArgs<V, L>) = nullptr;
  if (route == kRelsl) kernel = sell_vals_grad_kernel<MergedWord, V, L>;
  if (route == kSplit && a.slice != nullptr) {
    kernel = sell_vals_grad_kernel<SplitPlanes, V, L>;
  }
  const long long blocks = (a.n_slots + kThreads - 1) / kThreads;
  if (kernel == nullptr || a.k < 1 || blocks < 1 || blocks > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  void* params[] = {&a};
  cudaError_t err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel),
                                     dim3(static_cast<unsigned>(blocks)),
                                     dim3(kThreads), params, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// route: sell::kRelsl (merged word in meta, slice null) or sell::kSplit
// (rel_tile in meta, slice_of in slice). value_kind: 0 = float32,
// 1 = bfloat16 (X). lidx_kind: 0 = int8, 1 = int32. X and G have k
// columns; out is the (n_slots / 128, 128) float32 gradient plane.
extern "C" int sell_vals_grad_launch(int route, const void* lidx,
                                     const void* meta, const void* slice,
                                     const void* tile_base, const void* x,
                                     const void* g, void* out,
                                     long long n_slots, int chunk, int k,
                                     int value_kind, int lidx_kind,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = sell::with_types(value_kind, lidx_kind, [&](auto v, auto l) {
    using V = typename decltype(v)::type;
    using L = typename decltype(l)::type;
    return launch_vals_grad(
        route,
        sell::MatArgs<V, L>{nullptr, static_cast<const L*>(lidx),
                            static_cast<const int*>(meta),
                            static_cast<const int*>(slice),
                            static_cast<const int*>(tile_base),
                            static_cast<const V*>(x),
                            static_cast<const float*>(g),
                            static_cast<float*>(out), n_slots, 0, chunk, k,
                            0},
        st);
  });
  return static_cast<int>(err);
}
