// glcm_grid: per non-overlapping window of a quantised band, the five GLCM
// properties of the symmetric, normalised co-occurrence matrix of each
// pixel offset, averaged over the offsets.
// (B, H, W) int32 levels -> (B, n_i, n_j, 5) f32 in the order contrast,
// dissimilarity, homogeneity, energy, correlation.
//
// Replaces: rs_image_segmentation_tpu/ops/pallas_kernels.py
//   glcm_grid_pallas (kernel body _glcm_pairs_kernel).
//
// Semantics (skimage graycomatrix(symmetric, normed) + graycoprops, as
// ops/texture.py's XLA route): for an offset (dr, dc) the pairs of a
// window are (q[r][c], q[r + dr][c + dc]) with both pixels inside the
// window; a pair with a level outside [0, levels) is not counted (the JAX
// one-hot forms drop it). With C the pair counts and c = C + C^T, p =
// c / sum(c); correlation is 1 where std < 1e-15; a window with no pair
// gives 0, 0, 0, 0, 1.
//
// What bounds it on an H100: at the default configuration (levels 32,
// window = step = 21, four offsets, 600 x 600) the least time is set by
// bytes, about 1.4 MB of levels read, 0.4 us; the work, about 1.3 M pair
// increments, is small, so launch latency and the block's barriers rule.
//
// What the design does about it:
//   * One block per window (the TPU's 8-window programs, bf16 one-hot MXU
//     products and pairs padded with -1 to 128 lanes are gone). The block
//     counts each offset's pairs into levels^2 int32 counts with shared
//     atomics, plus one count per |i - j|.
//   * The properties come from integer moments of the pairs, exact in
//     int64 and independent of the order the threads add them in:
//     n = #pairs, S1 = sum (a-b)^2, S2 = sum |a-b|, S3 = sum (a+b),
//     S4 = sum (a^2+b^2), S5 = sum a*b, and S6 = sum over pairs of
//     C[a][b] + C[b][a] = sum(C^2) + sum(C * C^T), so sum(c^2) = 2 S6.
//     Then, c summing to 2n and its i and j moments being equal:
//       contrast = S1 / n, dissimilarity = S2 / n,
//       homogeneity = (sum over d of cnt[d] / (1 + d^2)) / n,
//       energy = sqrt(2 S6) / (2n),
//       correlation = (4n S5 - S3^2) / (2n S4 - S3^2), or 1 where the
//       variance numerator 2n S4 - S3^2 is 0 (std < 1e-15 exactly then).
//     The last steps run in f64 in one fixed order (d ascending, offsets
//     in order) and round once to f32; the plain version in
//     ops/kernels.py does the same operations with torch ops, so the two
//     are bit-equal, where an f32 tree reduction could not be. This
//     source builds with --fmad=false (ops/_build.py).
//   * Counts are cleared by walking the pairs again (O(pairs), not
//     O(levels^2)). When levels^2 + levels counts exceed kMaxSmemBytes the
//     counts live in a global scratch slot per block (zeroed by the
//     wrapper, left zeroed by the kernel) and blocks loop over windows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOffsets = 16;
constexpr int kMoments = 7;            // n, S1 .. S6
constexpr size_t kMaxSmemBytes = 200 * 1024;

struct Offsets {
  int n;
  int dr[kMaxOffsets];
  int dc[kMaxOffsets];
};

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  return v;
}

// Visits every pair of offset (dr, dc) in the window at (row0, col0):
// f(a, b) with a, b the two levels, both checked to lie in [0, levels).
template <typename F>
__device__ __forceinline__ void for_pairs(const int32_t* __restrict__ q,
                                          int width, int row0, int col0,
                                          int window, int dr, int dc,
                                          int levels, F f) {
  const int r0 = max(0, -dr), r1 = min(window, window - dr);
  const int c0 = max(0, -dc), c1 = min(window, window - dc);
  const int pw = c1 - c0;
  const int n = (r1 - r0) * pw;
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const int r = row0 + r0 + k / pw;
    const int c = col0 + c0 + k % pw;
    const int a = __ldg(&q[(long long)r * width + c]);
    const int b = __ldg(&q[(long long)(r + dr) * width + c + dc]);
    if (a >= 0 && a < levels && b >= 0 && b < levels) f(a, b);
  }
}

__global__ void __launch_bounds__(kThreads)
glcm_kernel(const int32_t* __restrict__ q, int height, int width, int levels,
            int window, int step, int n_i, int n_j, int n_windows,
            Offsets off, int* __restrict__ scratch, float* __restrict__ out) {
  extern __shared__ int s_counts[];
  __shared__ long long s_part[kWarps][kMoments];
  __shared__ long long s_mom[kMoments];
  const int tid = threadIdx.x;
  const int ll = levels * levels;
  int* cnt = scratch == nullptr
                 ? s_counts
                 : scratch + (long long)blockIdx.x * (ll + levels);
  int* hd = cnt + ll;                      // counts per |a - b|
  if (scratch == nullptr) {
    for (int i = tid; i < ll + levels; i += kThreads) cnt[i] = 0;
  }
  __syncthreads();

  for (int win = blockIdx.x; win < n_windows; win += gridDim.x) {
    const int per_band = n_i * n_j;
    const int band = win / per_band;
    const int wi = (win % per_band) / n_j;
    const int wj = win % n_j;
    const int32_t* qb = q + (long long)band * height * width;
    const int row0 = wi * step, col0 = wj * step;
    double sum[5] = {0.0, 0.0, 0.0, 0.0, 0.0};

    for (int o = 0; o < off.n; ++o) {
      const int dr = off.dr[o], dc = off.dc[o];
      long long m[kMoments] = {0, 0, 0, 0, 0, 0, 0};
      for_pairs(qb, width, row0, col0, window, dr, dc, levels,
                [&](int a, int b) {
                  const int d = a - b;
                  atomicAdd(&cnt[a * levels + b], 1);
                  atomicAdd(&hd[d < 0 ? -d : d], 1);
                  m[0] += 1;
                  m[1] += d * d;
                  m[2] += d < 0 ? -d : d;
                  m[3] += a + b;
                  m[4] += (long long)a * a + (long long)b * b;
                  m[5] += (long long)a * b;
                });
      __syncthreads();
      for_pairs(qb, width, row0, col0, window, dr, dc, levels,
                [&](int a, int b) {
                  m[6] += cnt[a * levels + b] + cnt[b * levels + a];
                });
#pragma unroll
      for (int k = 0; k < kMoments; ++k) {
        const long long v = warp_sum(m[k]);
        if ((tid & 31) == 0) s_part[tid >> 5][k] = v;
      }
      __syncthreads();
      if (tid < kMoments) {
        long long v = 0;
        for (int w = 0; w < kWarps; ++w) v += s_part[w][tid];
        s_mom[tid] = v;
      }
      __syncthreads();
      if (tid == 0) {
        const long long n = s_mom[0];
        double contrast = 0.0, dissim = 0.0, homog = 0.0, energy = 0.0;
        double corr = 1.0;
        if (n > 0) {
          const double nd = static_cast<double>(n);
          contrast = static_cast<double>(s_mom[1]) / nd;
          dissim = static_cast<double>(s_mom[2]) / nd;
          double h = 0.0;
          for (int d = 0; d < levels; ++d) {
            h = h + static_cast<double>(hd[d])
                        / static_cast<double>(1LL + (long long)d * d);
          }
          homog = h / nd;
          energy = sqrt(static_cast<double>(2 * s_mom[6]))
                   / static_cast<double>(2 * n);
          const long long s3sq = s_mom[3] * s_mom[3];
          const long long var_num = 2 * n * s_mom[4] - s3sq;
          const long long cov_num = 4 * n * s_mom[5] - s3sq;
          if (var_num != 0) {
            corr = static_cast<double>(cov_num)
                   / static_cast<double>(var_num);
          }
        }
        sum[0] = sum[0] + contrast;
        sum[1] = sum[1] + dissim;
        sum[2] = sum[2] + homog;
        sum[3] = sum[3] + energy;
        sum[4] = sum[4] + corr;
      }
      __syncthreads();                     // hd read before it is cleared
      for_pairs(qb, width, row0, col0, window, dr, dc, levels,
                [&](int a, int b) { cnt[a * levels + b] = 0; });
      for (int d = tid; d < levels; d += kThreads) hd[d] = 0;
      __syncthreads();
    }
    if (tid == 0) {
      const double n_off = static_cast<double>(off.n);
      float* o = out + (long long)win * 5;
#pragma unroll
      for (int k = 0; k < 5; ++k) o[k] = static_cast<float>(sum[k] / n_off);
    }
  }
}

}  // namespace

// Shared memory a block's counts need; above the limit the wrapper passes
// a zeroed global scratch of (grid, levels^2 + levels) int32.
extern "C" long long glcm_smem_bytes(int levels) {
  return 4LL * ((long long)levels * levels + levels);
}

extern "C" long long glcm_smem_limit() {
  return static_cast<long long>(kMaxSmemBytes);
}

// q: (batch, height, width) int32; offsets: n_offsets pairs (dr, dc) as
// int32 [dr0, dc0, dr1, dc1, ...] in host memory; scratch: null, or
// (grid, levels^2 + levels) int32 zeros in device memory; out: (batch,
// n_i, n_j, 5) f32. grid: blocks to launch (n_windows with shared counts).
// Returns the cudaError_t of the launch.
extern "C" int glcm_launch(const void* q, int batch, int height, int width,
                           int levels, int window, int step,
                           const int* offsets, int n_offsets, void* scratch,
                           int grid, void* out, void* stream) {
  if (batch < 1 || levels < 1 || levels > 46340 || window < 1 || step < 1
      || window > height || window > width || n_offsets < 1
      || n_offsets > kMaxOffsets || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Offsets off;
  off.n = n_offsets;
  for (int o = 0; o < n_offsets; ++o) {
    off.dr[o] = offsets[2 * o];
    off.dc[o] = offsets[2 * o + 1];
    if (off.dr[o] <= -window || off.dr[o] >= window
        || off.dc[o] <= -window || off.dc[o] >= window) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int n_i = (height - window) / step + 1;
  const int n_j = (width - window) / step + 1;
  const long long n_windows = (long long)batch * n_i * n_j;
  if (n_windows >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  if (scratch == nullptr) {
    smem = static_cast<size_t>(glcm_smem_bytes(levels));
    if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          glcm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  }
  glcm_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(q), height, width, levels, window, step,
      n_i, n_j, static_cast<int>(n_windows), off, static_cast<int*>(scratch),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
