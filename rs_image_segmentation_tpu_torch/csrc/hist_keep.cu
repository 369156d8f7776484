// hist_dense and keep_lut: the component-area histogram and the keep-bit
// lookup of the batched min-area removal.
//
//   hist_dense: (M, N) int32 ids -> (M, bins) int32 exact counts of each
//     id in [0, bins) per mask; negative ids and ids >= bins not counted.
//   keep_lut:   (M, N) int32 ids + (M, bins) uint8 0/1 table -> (M, N)
//     int32 keep bits; ids outside [0, bins) read 0.
//
// Replaces: rs_image_segmentation_tpu/ops/pallas_kernels.py
//   hist_dense_pallas (_hist_dense_kernel) and keep_lut_pallas
//   (_keep_lut_kernel). The TPU computed both as one-hot (hi, lo) matmuls
//   on the MXU, because a scatter or a gather is slow there; a Hopper SM
//   has shared-memory atomics and cached gathers, so neither needs the
//   one-hot form nor the bins tiers that cut its cost.
//
// What bounds them on an H100: bytes. At the rule path's first stage
// (24 masks x 360 000 ids, bins 32768) hist_dense reads 34.6 MB of ids and
// writes 3.1 MB of counts (about 11 us at 3.35 TB/s); keep_lut reads the
// ids and writes 34.6 MB of bits (about 21 us).
//
// What the design does about it:
//   * hist_dense: each block takes one slice of one mask and counts into a
//     private histogram of all `bins` ints in shared memory (128 KB for
//     32768 bins, within the 227 KB a block may have), then adds each
//     nonzero bin into the output with one global atomicAdd. Lanes of a
//     warp holding the same id (a large component, or the background id)
//     are merged with __match_any_sync first, so one atomic serves them.
//     When the histogram does not fit in shared memory the blocks count
//     straight into the output with global atomics. Integer atomics are
//     exact in any order. The output must be zeroed first.
//   * keep_lut: a streaming pass, 16 bytes of ids in and 16 bytes of bits
//     out per thread where alignment allows; the table reads go through
//     the read-only cache (32 KB per mask at 32768 bins).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHistThreads = 1024;
constexpr int kKeepThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmemBytes = 227 * 1024;

template <bool kShared>
__global__ void __launch_bounds__(kHistThreads)
hist_dense_kernel(const int* __restrict__ ids, int* __restrict__ counts,
                  long long n, int bins, long long span) {
  extern __shared__ int s_hist[];
  const int m = blockIdx.y;
  int* dst = kShared ? s_hist : counts + static_cast<long long>(m) * bins;
  if (kShared) {
    for (int i = threadIdx.x; i < bins; i += kHistThreads) s_hist[i] = 0;
    __syncthreads();
  }
  const int* src = ids + static_cast<long long>(m) * n;
  const long long lo = blockIdx.x * span;
  const long long hi = lo + span < n ? lo + span : n;
  const int lane = threadIdx.x & 31;
  // every lane runs the same number of steps: the warp intrinsics need all
  for (long long base = lo; base < hi; base += kHistThreads) {
    const long long i = base + threadIdx.x;
    const int id = i < hi ? src[i] : -1;
    const bool ok = static_cast<unsigned>(id) < static_cast<unsigned>(bins);
    const unsigned peers = __match_any_sync(kFull, ok ? id : -1);
    if (ok && lane == __ffs(peers) - 1) atomicAdd(&dst[id], __popc(peers));
  }
  if (kShared) {
    __syncthreads();
    int* out = counts + static_cast<long long>(m) * bins;
    for (int i = threadIdx.x; i < bins; i += kHistThreads) {
      const int c = s_hist[i];
      if (c) atomicAdd(&out[i], c);
    }
  }
}

__device__ __forceinline__ int keep_bit(const uint8_t* tab, int id,
                                        int bins) {
  return static_cast<unsigned>(id) < static_cast<unsigned>(bins)
      ? static_cast<int>(__ldg(tab + id) != 0) : 0;
}

template <bool kVec>
__global__ void __launch_bounds__(kKeepThreads)
keep_lut_kernel(const int* __restrict__ ids, const uint8_t* __restrict__ table,
                int* __restrict__ out, long long n, int bins) {
  const long long m = blockIdx.y;
  const int* src = ids + m * n;
  int* dst = out + m * n;
  const uint8_t* tab = table + m * bins;
  const long long step = static_cast<long long>(gridDim.x) * kKeepThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kKeepThreads + threadIdx.x;
  if (kVec) {
    // n % 4 == 0 and both bases 16-byte aligned (checked by the host)
    const int4* src4 = reinterpret_cast<const int4*>(src);
    int4* dst4 = reinterpret_cast<int4*>(dst);
    for (long long i = first; i < n / 4; i += step) {
      const int4 v = src4[i];
      dst4[i] = make_int4(keep_bit(tab, v.x, bins), keep_bit(tab, v.y, bins),
                          keep_bit(tab, v.z, bins), keep_bit(tab, v.w, bins));
    }
  } else {
    for (long long i = first; i < n; i += step) {
      dst[i] = keep_bit(tab, src[i], bins);
    }
  }
}

int sm_count() {
  int dev = 0;
  int sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

}  // namespace

// ids: (m, n) int32; counts: (m, bins) int32, zero-filled. Returns the
// cudaError_t of the launch.
extern "C" int hist_dense_launch(const void* ids, void* counts, int m,
                                 long long n, int bins, void* stream) {
  if (m <= 0 || m > 65535 || n <= 0 || bins <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // about two blocks per SM over the whole batch, each slice a multiple
  // of the block's width
  long long per_mask = (2LL * sm_count() + m - 1) / m;
  const long long most = (n + kHistThreads - 1) / kHistThreads;
  if (per_mask > most) per_mask = most;
  long long span = (n + per_mask - 1) / per_mask;
  span = (span + kHistThreads - 1) / kHistThreads * kHistThreads;
  const dim3 grid(static_cast<unsigned>((n + span - 1) / span),
                  static_cast<unsigned>(m));
  auto s = static_cast<cudaStream_t>(stream);
  auto src = static_cast<const int*>(ids);
  auto dst = static_cast<int*>(counts);
  const long long smem = static_cast<long long>(bins) * sizeof(int);
  if (smem <= kMaxSmemBytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        hist_dense_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    hist_dense_kernel<true><<<grid, kHistThreads, smem, s>>>(src, dst, n,
                                                              bins, span);
  } else {
    hist_dense_kernel<false><<<grid, kHistThreads, 0, s>>>(src, dst, n, bins,
                                                           span);
  }
  return static_cast<int>(cudaGetLastError());
}

// ids: (m, n) int32; table: (m, bins) uint8 (0/1); out: (m, n) int32.
// Returns the cudaError_t of the launch.
extern "C" int keep_lut_launch(const void* ids, const void* table, void* out,
                               int m, long long n, int bins, void* stream) {
  if (m <= 0 || m > 65535 || n <= 0 || bins <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = n % 4 == 0
      && reinterpret_cast<uintptr_t>(ids) % 16 == 0
      && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long units = vec ? n / 4 : n;
  long long bx = (units + kKeepThreads - 1) / kKeepThreads;
  const long long cap = (8LL * sm_count() + m - 1) / m;
  if (bx > cap) bx = cap;
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(m));
  auto s = static_cast<cudaStream_t>(stream);
  auto src = static_cast<const int*>(ids);
  auto tab = static_cast<const uint8_t*>(table);
  auto dst = static_cast<int*>(out);
  if (vec) {
    keep_lut_kernel<true><<<grid, kKeepThreads, 0, s>>>(src, tab, dst, n, bins);
  } else {
    keep_lut_kernel<false><<<grid, kKeepThreads, 0, s>>>(src, tab, dst, n,
                                                         bins);
  }
  return static_cast<int>(cudaGetLastError());
}
