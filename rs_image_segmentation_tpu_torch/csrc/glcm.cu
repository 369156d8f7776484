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
// The properties come from integer moments of the pairs, exact in int64
// and independent of the order the threads add them in:
//   n = #pairs, S1 = sum (a-b)^2, S2 = sum |a-b|, S3 = sum (a+b),
//   S4 = sum (a^2+b^2), S5 = sum a*b, and S6 = sum over pairs of
//   C[a][b] + C[b][a] = sum(C^2) + sum(C * C^T), so sum(c^2) = 2 S6.
// Then, c summing to 2n and its i and j moments being equal:
//   contrast = S1 / n, dissimilarity = S2 / n,
//   homogeneity = (sum over d of cnt[d] / (1 + d^2)) / n,
//   energy = sqrt(2 S6) / (2n),
//   correlation = (4n S5 - S3^2) / (2n S4 - S3^2), or 1 where the
//   variance numerator 2n S4 - S3^2 is 0 (std < 1e-15 exactly then).
// The last steps run in f64 in one fixed order (each d's term divided on
// its own, the terms summed d ascending, the offsets summed in order) and
// round once to f32; the plain version in ops/kernels.py does the same
// operations with torch ops, so the two are bit-equal, where an f32 tree
// reduction could not be. This source builds with --fmad=false
// (ops/_build.py).
//
// What bounds it on an H100: at the default configuration (levels 32,
// window = step = 21, four offsets, 600 x 600) bytes set the least time,
// about 1.4 MB of levels read, 0.4 us; the work, about 1.3 M pair
// increments, is small. With 784 windows all blocks are resident at once,
// so the launch takes as long as one block's chain of dependent steps,
// and a launch's own latency, some 2-4 us, is the practical floor.
//
// The first design ran one 128-thread block per window with the offsets
// one after another: per offset three passes over the window's pairs in
// global memory (count, S6, clear), four __syncthreads, a block reduction
// of the moments through shared memory, and thread 0 alone running the
// levels f64 divides in a chain: some 12 global passes, 20 barriers and
// 130 serial divides per window.
//
// What the shared instance (glcm_kernel) does about it:
//   * The window is staged into shared memory once, with levels outside
//     [0, levels) stored as -1; one block barrier follows.
//   * One warp per offset (offsets past the warp count loop, the warp then
//     clears its counts by walking its pairs again). Each warp keeps its
//     own levels^2 + levels counts in shared memory (4 x 4.2 KB at 32
//     levels), so counting, S6 and the moment sums need only __syncwarp
//     and shuffles.
//   * With every block resident at once, the SMs' instruction issue is
//     what is left, so a lane does little per pair: it steps its pairs'
//     row and column without a division, keeps its moments in int32
//     (exact within the shared instance's sizes) and the warp sums them in
//     int64 with shuffles.
//   * The epilogue runs on the warp's lanes: lane d forms hd[d] / (1 + d^2)
//     (all divides at once), lane 0 sums the terms d ascending; lanes 1-4
//     form contrast, dissimilarity, energy and correlation meanwhile.
//   * After the second and last block barrier, threads 0-4 each sum one
//     property over the offsets in offset order and divide by the count.
// The global instance (glcm_global_kernel) serves levels whose counts do
// not fit even one warp's shared memory (levels 256: 263 KB an offset):
// the first design, with each block's counts in a zeroed global scratch
// slot (left zeroed), blocks looping over windows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;          // the global instance's block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWarps = 4;           // the shared instance: one per offset
constexpr int kMaxOffsets = 16;
constexpr int kMoments = 7;            // n, S1 .. S6
constexpr int kProps = 5;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSmemBytes = 200 * 1024;

struct Offsets {
  int n;
  int dr[kMaxOffsets];
  int dc[kMaxOffsets];
};

// The sum over the warp, in lane 0.
__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(kFull, v, s);
  return v;
}

// The sum over the warp, in every lane.
__device__ __forceinline__ long long warp_allsum(long long v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(kFull, v, s);
  return v;
}

// The five properties of one offset into props[0..4], from its moments
// (the same in every lane) and its counts per |a - b|, over the warp's
// lanes: every lane divides its own d's terms, the terms are summed d
// ascending, and lanes 0-4 each form one property.
__device__ __forceinline__ void offset_props(const long long (&mom)[kMoments],
                                             const int* hd, int levels,
                                             int lane, double* props) {
  const long long n = mom[0];
  const double nd = static_cast<double>(n);
  if (n > 0) {
    if (lane == 1) props[0] = static_cast<double>(mom[1]) / nd;
    if (lane == 2) props[1] = static_cast<double>(mom[2]) / nd;
    if (lane == 3) {
      props[3] = sqrt(static_cast<double>(2 * mom[6]))
                 / static_cast<double>(2 * n);
    }
    if (lane == 4) {
      const long long s3sq = mom[3] * mom[3];
      const long long var_num = 2 * n * mom[4] - s3sq;
      const long long cov_num = 4 * n * mom[5] - s3sq;
      props[4] = var_num != 0 ? static_cast<double>(cov_num)
                                    / static_cast<double>(var_num)
                              : 1.0;
    }
  } else if (lane < kProps) {
    props[lane] = lane == 4 ? 1.0 : 0.0;
  }
  // the shuffles do not wait on the sum: unrolled, only the adds chain
  double h = 0.0;
  for (int d0 = 0; d0 < levels; d0 += 32) {
    const int d = d0 + lane;
    const double term = d < levels
        ? static_cast<double>(hd[d])
              / static_cast<double>(1LL + static_cast<long long>(d) * d)
        : 0.0;
    const int top = levels - d0;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const double t = __shfl_sync(kFull, term, k);
      if (k < top) h = h + t;
    }
  }
  if (lane == 0 && n > 0) props[2] = h / nd;
}

// Calls f(at) with the shared-memory index of the first pixel of each pair
// of this lane: pairs lane, lane + 32, ... of the (r1 - r0) x pw pairs that
// start at (r0, c0), the row and column stepped without a division.
template <typename F>
__device__ __forceinline__ void for_lane_pairs(int lane, int r0, int r1,
                                               int c0, int pw, int window,
                                               F f) {
  const int np = (r1 - r0) * pw;
  const int r_step = 32 / pw, c_step = 32 - r_step * pw;
  int r = lane / pw;
  int c = lane - r * pw;
#pragma unroll 4
  for (int k = lane; k < np; k += 32) {
    f((r0 + r) * window + c0 + c);
    r += r_step;
    c += c_step;
    if (c >= pw) {
      c -= pw;
      ++r;
    }
  }
}

__global__ void __launch_bounds__(kMaxWarps * 32)
glcm_kernel(const int32_t* __restrict__ q, int height, int width, int levels,
            int window, int step, int n_i, int n_j, Offsets off,
            float* __restrict__ out) {
  extern __shared__ double s_props[];  // [offset][5]
  const int warps = blockDim.x >> 5;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ll = levels * levels;
  const int per_warp = ll + levels;
  int* s_counts = reinterpret_cast<int*>(s_props + off.n * kProps);
  int* s_win = s_counts + warps * per_warp;          // [window][window]

  const int win = blockIdx.x;
  const int per_band = n_i * n_j;
  const int band = win / per_band;
  const int wi = (win % per_band) / n_j;
  const int wj = win % n_j;
  const int32_t* qw = q + (long long)band * height * width
                      + (long long)(wi * step) * width + wj * step;
  for (int r = warp; r < window; r += warps) {
    for (int c = lane; c < window; c += 32) {
      const int v = __ldg(qw + (long long)r * width + c);
      s_win[r * window + c] = v >= 0 && v < levels ? v : -1;
    }
  }
  for (int i = tid; i < warps * per_warp; i += blockDim.x) s_counts[i] = 0;
  __syncthreads();

  int* cnt = s_counts + warp * per_warp;
  int* hd = cnt + ll;                      // counts per |a - b|
  for (int o = warp; o < off.n; o += warps) {
    const int dr = off.dr[o], dc = off.dc[o];
    const int r0 = max(0, -dr), r1 = min(window, window - dr);
    const int c0 = max(0, -dc), c1 = min(window, window - dc);
    const int pw = c1 - c0;
    const int shift = dr * window + dc;
    // a lane's sums fit int32: the shared instance holds window <= 226
    // and levels <= 226 (glcm_warps), so at most 1 600 pairs a lane, each
    // adding at most 2 * 225^2 to S4
    int m[kMoments] = {0, 0, 0, 0, 0, 0, 0};
    for_lane_pairs(lane, r0, r1, c0, pw, window, [&](int at) {
      const int a = s_win[at], b = s_win[at + shift];
      if (a >= 0 && b >= 0) {
        const int d = a - b;
        const int ad = d < 0 ? -d : d;
        atomicAdd(&cnt[a * levels + b], 1);
        atomicAdd(&hd[ad], 1);
        m[0] += 1;
        m[1] += d * d;
        m[2] += ad;
        m[3] += a + b;
        m[4] += a * a + b * b;
        m[5] += a * b;
      }
    });
    __syncwarp();
    for_lane_pairs(lane, r0, r1, c0, pw, window, [&](int at) {
      const int a = s_win[at], b = s_win[at + shift];
      if (a >= 0 && b >= 0) m[6] += cnt[a * levels + b] + cnt[b * levels + a];
    });
    long long mom[kMoments];
#pragma unroll
    for (int k = 0; k < kMoments; ++k) mom[k] = warp_allsum(m[k]);
    offset_props(mom, hd, levels, lane, s_props + o * kProps);
    if (o + warps < off.n) {               // another offset: clear the counts
      __syncwarp();
      for_lane_pairs(lane, r0, r1, c0, pw, window, [&](int at) {
        const int a = s_win[at], b = s_win[at + shift];
        if (a >= 0 && b >= 0) cnt[a * levels + b] = 0;
      });
      for (int d = lane; d < levels; d += 32) hd[d] = 0;
      __syncwarp();
    }
  }
  __syncthreads();
  if (tid < kProps) {
    double sum = 0.0;
    for (int o = 0; o < off.n; ++o) sum = sum + s_props[o * kProps + tid];
    out[(long long)win * kProps + tid] =
        static_cast<float>(sum / static_cast<double>(off.n));
  }
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
glcm_global_kernel(const int32_t* __restrict__ q, int height, int width,
                   int levels, int window, int step, int n_i, int n_j,
                   int n_windows, Offsets off, int* __restrict__ scratch,
                   float* __restrict__ out) {
  __shared__ long long s_part[kWarps][kMoments];
  __shared__ long long s_mom[kMoments];
  const int tid = threadIdx.x;
  const int ll = levels * levels;
  int* cnt = scratch + (long long)blockIdx.x * (ll + levels);
  int* hd = cnt + ll;                      // counts per |a - b|

  for (int win = blockIdx.x; win < n_windows; win += gridDim.x) {
    const int per_band = n_i * n_j;
    const int band = win / per_band;
    const int wi = (win % per_band) / n_j;
    const int wj = win % n_j;
    const int32_t* qb = q + (long long)band * height * width;
    const int row0 = wi * step, col0 = wj * step;
    double sum[kProps] = {0.0, 0.0, 0.0, 0.0, 0.0};

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
      float* o = out + (long long)win * kProps;
#pragma unroll
      for (int k = 0; k < kProps; ++k) {
        o[k] = static_cast<float>(sum[k] / n_off);
      }
    }
  }
}

// Shared memory of the shared instance with `warps` warps: the offsets'
// properties, each warp's levels^2 + levels counts, and the window.
long long smem_bytes(int levels, int window, int n_offsets, int warps) {
  return 8LL * kProps * n_offsets
         + 4LL * warps * ((long long)levels * levels + levels)
         + 4LL * window * window;
}

}  // namespace

// Warps a block of the shared instance takes (one per offset, at most
// kMaxWarps, fewer where their counts would not fit); 0 when not even one
// warp's counts fit: the global instance then takes the call.
extern "C" int glcm_warps(int levels, int window, int n_offsets) {
  int warps = n_offsets < kMaxWarps ? n_offsets : kMaxWarps;
  while (warps > 0 && smem_bytes(levels, window, n_offsets, warps)
                          > static_cast<long long>(kMaxSmemBytes)) {
    --warps;
  }
  return warps;
}

// q: (batch, height, width) int32; offsets: n_offsets pairs (dr, dc) as
// int32 [dr0, dc0, dr1, dc1, ...] in host memory; scratch: null for the
// shared instance (glcm_warps > 0; grid = the window count), else the
// global instance's (grid, levels^2 + levels) int32 zeros in device memory;
// out: (batch, n_i, n_j, 5) f32. Returns the cudaError_t of the launch.
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
  auto s = static_cast<cudaStream_t>(stream);
  auto src = static_cast<const int32_t*>(q);
  auto dst = static_cast<float*>(out);
  if (scratch != nullptr) {
    glcm_global_kernel<<<grid, kThreads, 0, s>>>(
        src, height, width, levels, window, step, n_i, n_j,
        static_cast<int>(n_windows), off, static_cast<int*>(scratch), dst);
    return static_cast<int>(cudaGetLastError());
  }
  const int warps = glcm_warps(levels, window, n_offsets);
  if (warps < 1 || grid != n_windows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      static_cast<size_t>(smem_bytes(levels, window, n_offsets, warps));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        glcm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  glcm_kernel<<<grid, warps * 32, smem, s>>>(src, height, width, levels,
                                             window, step, n_i, n_j, off,
                                             dst);
  return static_cast<int>(cudaGetLastError());
}
