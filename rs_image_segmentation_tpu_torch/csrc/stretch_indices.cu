// Two elementwise passes of stages 1 and 2.
//
// fused_calibrate_stretch: (C, H, W) DNs (uint8, uint16 or f32) with
// per-band gains, biases and stretch ends -> (C, H, W) f32 in [0, 255],
//   cal = dn * gain + bias;  out = (cal - mn) * 255 / (mx - mn).
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
// writes 4 B per pixel; the indices read 5 and write 7 f32 per pixel, a
// handful of operations per byte, far below the f32 rate.
//
// What the design does about it:
//   * One thread per pixel, consecutive threads on consecutive pixels, so
//     every plane is read and written in full coalesced lines; the five
//     bands are read once and the seven indices come from registers (the
//     TPU kernel's (8, 128) VMEM tiles and padding are gone).
//   * The per-band min and max of the DNs come from the wrapper
//     (torch.aminmax), outside the kernel, as the TPU version takes them in
//     XLA outside pallas_call. The wrapper forms mn and mx as the min and
//     max of gain*dmin + bias and gain*dmax + bias, which is right for a
//     negative gain too (the TPU kernel assumed gain > 0).
//   * Bit-equal to the plain PyTorch versions (ops/kernels.py): this
//     source builds with --fmad=false (ops/_build.py), so no product is
//     contracted into an FMA, and each expression keeps the plain
//     version's operation order: ((nir + 6 red) - 7.5 blue) + 1 for EVI's
//     denominator, whose 1e-3 guard flips a pixel between 0 and +-1 on an
//     ulp; (cal - mn) * 255 / (mx - mn) for the stretch (the stage-1 f32
//     path's order, not the TPU kernel's (cal - mn) * (255 / (mx - mn))).
//     Division and sqrtf are IEEE (nvcc's -prec-div and -prec-sqrt
//     defaults). The clip keeps a NaN, as torch.clamp does; a flat band
//     (mx == mn) divides by zero, as the JAX path does.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float clip1(float r) {
  return r < -1.0f ? -1.0f : (r > 1.0f ? 1.0f : r);
}

__device__ __forceinline__ float guarded(float num, float den) {
  return clip1(den > 1e-3f ? num / den : 0.0f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
calibrate_stretch_kernel(const T* __restrict__ dn,
                         const float* __restrict__ gains,
                         const float* __restrict__ biases,
                         const float* __restrict__ mn,
                         const float* __restrict__ mx, long long hw,
                         float* __restrict__ out) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int c = blockIdx.y;
  if (p >= hw) return;
  const long long i = (long long)c * hw + p;
  const float cal = static_cast<float>(dn[i]) * gains[c] + biases[c];
  out[i] = (cal - mn[c]) * 255.0f / (mx[c] - mn[c]);
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

template <typename T>
cudaError_t launch_stretch(const void* dn, const void* gains,
                           const void* biases, const void* mn, const void* mx,
                           int channels, long long hw, void* out,
                           cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((hw + kThreads - 1) / kThreads),
                  static_cast<unsigned>(channels));
  calibrate_stretch_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(dn), static_cast<const float*>(gains),
      static_cast<const float*>(biases), static_cast<const float*>(mn),
      static_cast<const float*>(mx), hw, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

// dn: (channels, hw) of dtype_code 0 = uint8, 1 = uint16, 2 = f32; gains,
// biases, mn, mx: (channels,) f32; out: (channels, hw) f32. Returns the
// cudaError_t of the launch.
extern "C" int calibrate_stretch_launch(const void* dn, int dtype_code,
                                        const void* gains,
                                        const void* biases, const void* mn,
                                        const void* mx, int channels,
                                        long long hw, void* out,
                                        void* stream) {
  if (channels < 1 || channels > 65535 || hw <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      return static_cast<int>(launch_stretch<uint8_t>(
          dn, gains, biases, mn, mx, channels, hw, out, s));
    case 1:
      return static_cast<int>(launch_stretch<uint16_t>(
          dn, gains, biases, mn, mx, channels, hw, out, s));
    case 2:
      return static_cast<int>(launch_stretch<float>(
          dn, gains, biases, mn, mx, channels, hw, out, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
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
