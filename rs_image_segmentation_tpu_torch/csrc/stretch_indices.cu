// Two elementwise passes of stages 1 and 2.
//
// fused_calibrate_stretch: (C, H, W) DNs (uint8, uint16 or f32) with
// per-band gains and biases -> (C, H, W) f32 in [0, 255],
//   cal = dn * gain + bias;  out = (cal - mn) * 255 / (mx - mn),
// mn and mx the band's calibrated extremes.
// Replaces: rs_image_segmentation_tpu/ops/pallas_kernels.py
//   fused_calibrate_stretch (kernel body _calib_stretch_kernel).
//
// fused_spectral_indices: (B, C >= 5, H, W) normalised f32 bands ->
// (B, 7, H, W) f32 [ndvi, evi, msavi, ndwi, mndwi, ndbi, bsi], each a
// guarded ratio (den > 1e-3, else 0) clipped to [-1, 1]; msavi unguarded.
// Replaces: rs_image_segmentation_tpu/ops/pallas_kernels.py
//   fused_spectral_indices (kernel body _indices_kernel).
//
// What bounds them on an H100: bytes. The stretch reads 2 B (uint16) and
// writes 4 B per pixel, 15.1 MB at stage 1's 7 x 600 x 600 (4.5 us at
// 3.35 TB/s); the indices read 5 and write 7 f32 per pixel; a handful of
// operations per byte, far below the f32 rate.
//
// fused_calibrate_stretch, what held the first design back: the per-band
// DN extremes came from torch ops around the kernel (a widened int32 copy
// of a uint16 scene, aminmax, stack, mul, add, a second aminmax), and
// host gains and biases were copied to the card before each call, each
// copy a host sync: about nine launches and two copies around an 8 us
// kernel, 45 us with the L2 flushed. The kernel read four per-band values
// from global memory on every pixel.
//
// What calibrate_stretch_kernel does about it:
//   * One launch per call. One thread-block cluster of kStretchCluster
//     blocks per band: block r takes the band's pixels [r * span,
//     (r + 1) * span) (ops/kernels.py::calibrate_stretch_plan), reduces
//     their DN min and max, and the cluster combines the 16 extremes
//     through distributed shared memory (map_shared_rank) after one
//     cluster barrier. The extremes are NaN-propagating, as torch.aminmax:
//     fminf and fmaxf would drop a NaN among f32 DNs.
//   * The staged instance (a slice of at most kStretchStageBytes, stage 1
//     at 600 x 600: 45 KB of uint16 or 90 KB of f32 a block) keeps the
//     slice in shared memory as it loads it, so each DN is read from HBM
//     once; the streamed instance (larger bands) reads the slice again.
//     The host picks the instance by shape.
//   * Units of 4 pixels: 4, 8 or 16 bytes of DNs in, one float4 out, so a
//     warp's store covers 512 contiguous bytes; kStretchUnroll loads in
//     flight a thread. Bands whose length is not a multiple of 4, or
//     misaligned bases, take units of one pixel.
//   * Gains and biases given on the host travel by value in a
//     __grid_constant__ parameter (at most kStretchMaxHostBands bands): no
//     copy, no host sync. Given on the card, they are read by pointer,
//     once per block.
//   * mn and mx are the min and max of gain * dmin + bias and gain * dmax
//     + bias in f32, right for a negative gain too and equal to the
//     extremes of the calibrated band, since f32 rounding is monotone.
//
// Both kernels are bit-equal to the plain PyTorch versions
// (ops/kernels.py): this source builds with --fmad=false (ops/_build.py),
// so no product is contracted into an FMA, and each expression keeps the
// plain version's operation order: ((nir + 6 red) - 7.5 blue) + 1 for
// EVI's denominator, whose 1e-3 guard flips a pixel between 0 and +-1 on
// an ulp; (cal - mn) * 255 / (mx - mn) for the stretch (the stage-1 f32
// path's order, not the TPU kernel's (cal - mn) * (255 / (mx - mn))).
// Division and sqrtf are IEEE (nvcc's -prec-div and -prec-sqrt defaults).
// The clip keeps a NaN, as torch.clamp does; a flat band (mx == mn)
// divides by zero, as the JAX path does.
//
// fused_spectral_indices: one thread per pixel, consecutive threads on
// consecutive pixels, so every plane is read and written in full coalesced
// lines; the five bands are read once and the seven indices come from
// registers (the TPU kernel's (8, 128) VMEM tiles and padding are gone).

#include <climits>
#include <cmath>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kStretchCluster = 16;       // STRETCH_CLUSTER: blocks a band
constexpr int kStretchThreads = 512;
constexpr int kStretchWarps = kStretchThreads / 32;
constexpr int kStretchUnroll = 4;         // loads in flight a thread
constexpr int kStretchStageBytes = 100 * 1024;   // STRETCH_STAGE_BYTES
constexpr int kStretchMaxHostBands = 128;  // STRETCH_MAX_HOST_BANDS
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float clip1(float r) {
  return r < -1.0f ? -1.0f : (r > 1.0f ? 1.0f : r);
}

__device__ __forceinline__ float guarded(float num, float den) {
  return clip1(den > 1e-3f ? num / den : 0.0f);
}

// Per-band gains and biases: on the card (pointers), or by value.
struct StretchArgs {
  const float* gains;                  // null: gain[] holds them
  const float* biases;                 // null: bias[] holds them
  float gain[kStretchMaxHostBands];
  float bias[kStretchMaxHostBands];
};

// N consecutive DNs as one aligned load.
template <typename T, int N>
struct __align__(sizeof(T) * N) Pack {
  T v[N];
};

// The DN extremes: int for uint8 and uint16, f32 for float DNs.
template <typename T> struct Ext {
  using type = int;
  static __device__ __forceinline__ int lo() { return INT_MAX; }
  static __device__ __forceinline__ int hi() { return INT_MIN; }
};
template <> struct Ext<float> {
  using type = float;
  static __device__ __forceinline__ float lo() { return INFINITY; }
  static __device__ __forceinline__ float hi() { return -INFINITY; }
};

__device__ __forceinline__ int lo_of(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int hi_of(int a, int b) { return a > b ? a : b; }
// NaN-propagating, as torch.aminmax (fminf and fmaxf drop a NaN)
__device__ __forceinline__ float lo_of(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float hi_of(float a, float b) {
  return (a > b || a != a) ? a : b;
}

template <typename A>
__device__ __forceinline__ void warp_extremes(A& lo, A& hi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = lo_of(lo, __shfl_xor_sync(kFull, lo, off));
    hi = hi_of(hi, __shfl_xor_sync(kFull, hi, off));
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

template <typename T, int N>
__device__ __forceinline__ void stretch_unit(const Pack<T, N>& v, float g,
                                             float b, float mn, float den,
                                             float* dst, long long i) {
  float o[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float cal = static_cast<float>(v.v[k]) * g + b;
    o[k] = (cal - mn) * 255.0f / den;
  }
  if constexpr (N == 4) {
    reinterpret_cast<float4*>(dst)[i] = make_float4(o[0], o[1], o[2], o[3]);
  } else {
    dst[i] = o[0];
  }
}

// One cluster per band (blockIdx.y); N pixels a unit; kStaged keeps the
// block's slice in shared memory between the two passes.
template <typename T, int N, bool kStaged>
__global__ void __launch_bounds__(kStretchThreads)
calibrate_stretch_kernel(const T* __restrict__ dn,
                         const __grid_constant__ StretchArgs args,
                         long long hw, long long span,
                         float* __restrict__ out) {
  using A = typename Ext<T>::type;
  using P = Pack<T, N>;
  extern __shared__ uint4 s_stage4[];            // the slice (kStaged)
  P* s_stage = reinterpret_cast<P*>(s_stage4);
  __shared__ A s_lo[kStretchWarps], s_hi[kStretchWarps];
  __shared__ A s_ext[2];                         // this block's, for the cluster
  __shared__ A s_band[2];                        // the band's

  const cg::cluster_group cluster = cg::this_cluster();
  const long long c = blockIdx.y;
  const long long lo = static_cast<long long>(cluster.block_rank()) * span;
  const long long hi = lo + span < hw ? lo + span : hw;
  const long long units = lo < hi ? (hi - lo) / N : 0;
  const P* src = reinterpret_cast<const P*>(dn + c * hw + lo);
  float* dst = out + c * hw + lo;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // pass 1: the slice's DN extremes (and the slice, staged)
  A dlo = Ext<T>::lo(), dhi = Ext<T>::hi();
  for (long long base = threadIdx.x; base < units;
       base += kStretchThreads * kStretchUnroll) {
    P v[kStretchUnroll];
#pragma unroll
    for (int u = 0; u < kStretchUnroll; ++u) {
      const long long i = base + u * kStretchThreads;
      if (i < units) v[u] = src[i];
    }
#pragma unroll
    for (int u = 0; u < kStretchUnroll; ++u) {
      const long long i = base + u * kStretchThreads;
      if (i < units) {
        if (kStaged) s_stage[i] = v[u];
#pragma unroll
        for (int k = 0; k < N; ++k) {
          dlo = lo_of(dlo, static_cast<A>(v[u].v[k]));
          dhi = hi_of(dhi, static_cast<A>(v[u].v[k]));
        }
      }
    }
  }
  warp_extremes(dlo, dhi);
  if (lane == 0) {
    s_lo[warp] = dlo;
    s_hi[warp] = dhi;
  }
  __syncthreads();
  if (warp == 0) {
    dlo = lane < kStretchWarps ? s_lo[lane] : Ext<T>::lo();
    dhi = lane < kStretchWarps ? s_hi[lane] : Ext<T>::hi();
    warp_extremes(dlo, dhi);
    if (lane == 0) {
      s_ext[0] = dlo;
      s_ext[1] = dhi;
    }
  }
  cluster.sync();              // every block's extremes (and slice) ready

  // the band's extremes from the cluster's blocks
  if (warp == 0) {
    dlo = Ext<T>::lo();
    dhi = Ext<T>::hi();
    if (lane < kStretchCluster) {
      const A* r = cluster.map_shared_rank(s_ext, lane);
      dlo = r[0];
      dhi = r[1];
    }
    warp_extremes(dlo, dhi);
    if (lane == 0) {
      s_band[0] = dlo;
      s_band[1] = dhi;
    }
  }
  __syncthreads();
  cluster_arrive();            // done reading the other blocks' memory
  const float g = args.gains ? args.gains[c] : args.gain[c];
  const float b = args.biases ? args.biases[c] : args.bias[c];
  const float e0 = static_cast<float>(s_band[0]) * g + b;
  const float e1 = static_cast<float>(s_band[1]) * g + b;
  const float mn = lo_of(e0, e1);
  const float den = hi_of(e0, e1) - mn;

  // pass 2: the stretch, from shared memory or the slice read again
  for (long long base = threadIdx.x; base < units;
       base += kStretchThreads * kStretchUnroll) {
    P v[kStretchUnroll];
#pragma unroll
    for (int u = 0; u < kStretchUnroll; ++u) {
      const long long i = base + u * kStretchThreads;
      if (i < units) v[u] = kStaged ? s_stage[i] : src[i];
    }
#pragma unroll
    for (int u = 0; u < kStretchUnroll; ++u) {
      const long long i = base + u * kStretchThreads;
      if (i < units) stretch_unit<T, N>(v[u], g, b, mn, den, dst, i);
    }
  }
  cluster_wait();              // no block leaves while others read it
}

__global__ void __launch_bounds__(kThreads)
spectral_indices_kernel(const float* __restrict__ bands, int n_bands,
                        long long hw, float* __restrict__ out) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long b = blockIdx.y;
  if (p >= hw) return;
  const float* x = bands + b * n_bands * hw + p;
  const float blue = x[0];
  const float green = x[hw];
  const float red = x[2 * hw];
  const float nir = x[3 * hw];
  const float swir1 = x[4 * hw];
  float* o = out + b * 7 * hw + p;
  o[0] = guarded(nir - red, nir + red);
  o[hw] = guarded(2.5f * (nir - red), nir + 6.0f * red - 7.5f * blue + 1.0f);
  const float t = 2.0f * nir + 1.0f;
  o[2 * hw] = clip1((t - sqrtf(t * t - 8.0f * (nir - red))) / 2.0f);
  o[3 * hw] = guarded(green - nir, green + nir);
  o[4 * hw] = guarded(green - swir1, green + swir1);
  o[5 * hw] = guarded(swir1 - nir, swir1 + nir);
  const float sr = swir1 + red;
  const float nb = nir + blue;
  o[6 * hw] = guarded(sr - nb, sr + nb);
}

template <typename T, int N, bool kStaged>
cudaError_t launch_stretch(const void* dn, const StretchArgs& args,
                           int channels, long long hw, long long span,
                           void* out, cudaStream_t stream) {
  auto kernel = calibrate_stretch_kernel<T, N, kStaged>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  static unsigned long long ready = 0;   // a bit per device: attributes set
  if (err == cudaSuccess && !(ready >> (dev & 63) & 1)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess && kStaged) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kStretchStageBytes);
    }
    if (err == cudaSuccess) ready |= 1ull << (dev & 63);
  }
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kStretchCluster, static_cast<unsigned>(channels));
  cfg.blockDim = dim3(kStretchThreads);
  cfg.dynamicSmemBytes = kStaged ? static_cast<size_t>(span) * sizeof(T) : 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kStretchCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(dn), args,
                           hw, span, static_cast<float*>(out));
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(bool vec, bool staged, const void* dn,
                         const StretchArgs& a, int channels, long long hw,
                         long long span, void* out, cudaStream_t s) {
  if (vec) {
    return staged ? launch_stretch<T, 4, true>(dn, a, channels, hw, span,
                                               out, s)
                  : launch_stretch<T, 4, false>(dn, a, channels, hw, span,
                                                out, s);
  }
  return staged ? launch_stretch<T, 1, true>(dn, a, channels, hw, span, out,
                                             s)
                : launch_stretch<T, 1, false>(dn, a, channels, hw, span, out,
                                              s);
}

}  // namespace

// dn: (channels, hw) of dtype_code 0 = uint8, 1 = uint16, 2 = f32; out:
// (channels, hw) f32. Gains and biases: (channels,) f32 host arrays
// (host_gains, host_biases; at most kStretchMaxHostBands, copied into the
// launch's parameters) or, where those are null, (channels,) f32 arrays on
// the card (gains, biases). span: the pixels a block of a band's cluster
// takes, ceil(ceil(hw / kStretchCluster) / 4) * 4; staged != 0 keeps them
// in shared memory, at most kStretchStageBytes
// (ops/kernels.py::calibrate_stretch_plan). Returns the cudaError_t of
// the launch.
extern "C" int calibrate_stretch_launch(const void* dn, int dtype_code,
                                        const float* host_gains,
                                        const float* host_biases,
                                        const void* gains,
                                        const void* biases, int channels,
                                        long long hw, long long span,
                                        int staged, void* out,
                                        void* stream) {
  static const int kSize[3] = {1, 2, 4};
  if (channels < 1 || channels > 65535 || hw <= 0 || dtype_code < 0
      || dtype_code > 2 || (!host_gains && !gains) || (!host_biases && !biases)
      || ((host_gains || host_biases) && channels > kStretchMaxHostBands)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long want = ((hw + kStretchCluster - 1) / kStretchCluster + 3)
                         / 4 * 4;
  const int size = kSize[dtype_code];
  if (span != want || (staged && span * size > kStretchStageBytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  StretchArgs a = {};
  a.gains = host_gains ? nullptr : static_cast<const float*>(gains);
  a.biases = host_biases ? nullptr : static_cast<const float*>(biases);
  for (int i = 0; host_gains && i < channels; ++i) a.gain[i] = host_gains[i];
  for (int i = 0; host_biases && i < channels; ++i) a.bias[i] = host_biases[i];
  // units of 4 pixels when every unit's DNs and float4 are aligned
  const bool vec = hw % 4 == 0
      && reinterpret_cast<uintptr_t>(dn) % (4 * size) == 0
      && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      return static_cast<int>(launch_dtype<uint8_t>(
          vec, staged != 0, dn, a, channels, hw, span, out, s));
    case 1:
      return static_cast<int>(launch_dtype<uint16_t>(
          vec, staged != 0, dn, a, channels, hw, span, out, s));
    default:
      return static_cast<int>(launch_dtype<float>(
          vec, staged != 0, dn, a, channels, hw, span, out, s));
  }
}

// bands: (batch, n_bands, hw) f32 with n_bands >= 5 (the first five are
// read); out: (batch, 7, hw) f32. Returns the cudaError_t of the launch.
extern "C" int spectral_indices_launch(const void* bands, int n_bands,
                                       int batch, long long hw, void* out,
                                       void* stream) {
  if (n_bands < 5 || batch < 1 || batch > 65535 || hw <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>((hw + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  spectral_indices_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(bands), n_bands, hw,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
