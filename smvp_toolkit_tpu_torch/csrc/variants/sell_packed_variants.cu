// Variants of K5 and K2-packed (csrc/sell_packed.cu, k = 1), built only by
// smvp_toolkit_tpu_torch/bench/bench_variants.py (--packed), which times
// them against the kept kernels and torch.sparse.mm on the same planes in
// one process; no entry point of the package launches them. Each computes
// K5's function on the packed word plane, resident or streamed y:
//   0 walk     the one-thread-per-slot walk K5 ran before (slot over
//              PackedWord): rel decoded from each slot's own word, a
//              64-bit divide for the chunk, the slice and tile_base loads
//              and a scalar atomic per slot
//   1 body     the kept body (sublane_sweep under PackedStage: rel from
//              lane 0's word and the slice staged once per sublane), built
//              here beside the others
//   2 perslot  the warp-per-sublane body with rel decoded per slot, not
//              staged: the block stages only the slice (slice_of), and
//              each of a thread's four words gathers x from its own rel's
//              tile; a dead rel (511) gives its slot no product
//   3 shfl     the kept semantics without the staging load of lane 0's
//              word: the block stages only the slice, and each warp takes
//              rel from the word of lane 0 it has just loaded (thread 0's
//              first word) with one __shfl_sync; a dead rel skips the
//              sublane after its load
// On the operator's planes (one rel in all 128 words of a sublane) the
// four compute the same y up to the summation order.
//
// K2-packed's forms (sell_bench_packed_variant_launch, resident y, N
// iterations in one cooperative launch):
//   0 walk     the one-thread-per-slot walk K2-packed ran before
//              (bench_sweeps over PackedWord: rel decoded per slot, one y
//              zeroed between two grid.sync()s an iteration), built as it
//              was (__launch_bounds__(kThreads)); result in y[0]
//   1 staged   K2's body under K5's policy (sublane_bench_sweeps<
//              PackedStage, ResidentY, 2>: rel staged from lane 0's word);
//              result in y[(N - 1) % 2]
//   2 shfl     the kept body (PackedShuffle: the slice staged alone, rel
//              from lane 0's loaded word by __shfl_sync), built here beside
//              the others; result in y[(N - 1) % 2]
// Forms 1 and 2 read rel from lane 0 on any plane, form 0 from each slot.

#include "../sell_packed.cu"

namespace {

template <class YAddr>
__global__ void __launch_bounds__(kThreads)
    walk_kernel(const Args<X, L> a) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < a.n_slots) slot<PackedWord, YAddr>(a, i);
}

// Variants 2 and 3: the body with the slice staged alone, rel per slot
// (PerSlot) or from lane 0's word by shuffle.
template <class YAddr, bool PerSlot>
__device__ __forceinline__ void slice_staged(const Args<X, L>& a) {
  __shared__ int s_slice[kRun];
  const int runs = runs_per_chunk(a.chunk);
  const int c = blockIdx.x / runs;
  const int first = (blockIdx.x - c * runs) * kRun;
  const int n = min(kRun, a.chunk - first);
  const long long s0 = static_cast<long long>(c) * a.chunk + first;
  const long long tile0 = a.tile_base[c];
  const long long ybase = YAddr::base(a, c);
  if (threadIdx.x < n) s_slice[threadIdx.x] = a.slice[s0 + threadIdx.x];
  __syncthreads();
  const int lane4 = 4 * (threadIdx.x & 31);
  const long long p0 = s0 * kLanes + lane4;
  float* y = a.y + ybase * kLanes + lane4;
  for (int j = threadIdx.x >> 5; j < n; j += kWarps) {
    const int slice = s_slice[j];
    if (slice < 0) continue;
    const int4 q =
        __ldcs(reinterpret_cast<const int4*>(a.meta + p0 + j * kLanes));
    const unsigned w[4] = {static_cast<unsigned>(q.x),
                           static_cast<unsigned>(q.y),
                           static_cast<unsigned>(q.z),
                           static_cast<unsigned>(q.w)};
    const unsigned r0 =
        PerSlot ? 0u
                : __shfl_sync(kFull, (w[0] >> kPackRelShift) & kRelDead, 0);
    if (!PerSlot && r0 == kRelDead) continue;
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned r = PerSlot ? (w[i] >> kPackRelShift) & kRelDead : r0;
      const long long col = (tile0 + r) * kLanes + (w[i] & kPackLaneMask);
      p[i] = r == kRelDead ? 0.0f
                           : __uint_as_float(w[i] & kPackValueMask) *
                                 to_f32(__ldg(a.x + col));
    }
    add_rows4(y + static_cast<long long>(slice) * kLanes, p);
  }
}

template <class YAddr>
__global__ void __launch_bounds__(kThreads, kSublaneMinBlocks)
    perslot_kernel(const Args<X, L> a) {
  slice_staged<YAddr, true>(a);
}

template <class YAddr>
__global__ void __launch_bounds__(kThreads, kSublaneMinBlocks)
    shfl_kernel(const Args<X, L> a) {
  slice_staged<YAddr, false>(a);
}

template <class YAddr>
cudaError_t launch_variant(int variant, const Args<X, L>& a,
                           cudaStream_t stream) {
  switch (variant) {
    case 0:
      return launch(reinterpret_cast<const void*>(walk_kernel<YAddr>), a,
                    a.n_slots, stream);
    case 1:
      return launch_packed(
          reinterpret_cast<const void*>(sell_packed_kernel<YAddr>), a,
          stream);
    case 2:
      return launch_packed(
          reinterpret_cast<const void*>(perslot_kernel<YAddr>), a, stream);
    case 3:
      return launch_packed(
          reinterpret_cast<const void*>(shfl_kernel<YAddr>), a, stream);
    default: return cudaErrorInvalidValue;
  }
}

__global__ void __launch_bounds__(kThreads)
    bench_walk_kernel(const Args<X, L> a) {
  bench_sweeps<PackedWord, ResidentY>(a);
}

template <class Stage>
__global__ void __launch_bounds__(kThreads, kSublaneMinBlocks)
    bench_form_kernel(const Args<X, L> a) {
  sublane_bench_sweeps<Stage, ResidentY, 2>(a);
}

}  // namespace

// K2-packed in one of its forms (0, 1, 2 above): arguments as
// sell_bench_packed_launch, after the form; y holds 2 * n_out floats.
extern "C" int sell_bench_packed_variant_launch(
    int form, const void* packed, const void* slice_of,
    const void* tile_base, const void* x, void* y, long long n_slots,
    long long n_out, int chunk, int iterations, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (iterations < 1 || slice_of == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args<X, L> a = packed_args(packed, slice_of, tile_base, nullptr, x, y,
                             n_slots, n_out, chunk, 0, iterations);
  if (!packed_aligned(a)) return static_cast<int>(cudaErrorMisalignedAddress);
  long long items = 0;
  if (!sublane_items(a, &items) || n_out % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void (*kernel)(Args<X, L>) = nullptr;
  if (form == 0) kernel = bench_walk_kernel;
  if (form == 1) kernel = bench_form_kernel<PackedStage>;
  if (form == 2) kernel = bench_form_kernel<PackedShuffle>;
  int blocks = 0;
  err = cooperative_grid(kernel, device, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(blocks), dim3(kThreads), params, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Arguments as sell_packed_launch, after the variant id; y zeroed by the
// caller.
extern "C" int sell_packed_variant_launch(int variant, const void* packed,
                                          const void* slice_of,
                                          const void* tile_base,
                                          const void* y_block_id,
                                          const void* x, void* y,
                                          long long n_slots, int chunk,
                                          int nsb, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((y_block_id != nullptr && nsb < 1) || slice_of == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args<X, L> a = packed_args(packed, slice_of, tile_base, y_block_id,
                                   x, y, n_slots, 0, chunk, nsb, 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(y_block_id == nullptr
                              ? launch_variant<ResidentY>(variant, a, st)
                              : launch_variant<StreamedY>(variant, a, st));
}
