// kmeans_lloyd: one Lloyd iteration of a batch of KMeans problems, the body
// of models/kmeans.py::fit_centroids' loop, in two kernels.
//
//   lloyd_partials_kernel: (B, N, F) f32 points and (B, K, F) f32
//     centroids -> per block of kPointsPerBlock points of a problem: each
//     cluster's point count (int32) and feature sums (f64), and the
//     block's farthest point (the largest clamped distance to its nearest
//     centroid, the lowest index among equals).
//   lloyd_update_kernel: one block a problem. The partials summed in a
//     fixed order into the new centroids (sum / count, rounded once to
//     f32; an empty cluster moved to the problem's farthest point), their
//     squared shift, and the loop's state updated in place for a problem
//     still active: centroids, shift, n_iter. It sets one flag when any
//     problem stays active.
//
// A problem is active while shift > tol and n_iter < max_iter, the test
// fit_centroids' plain loop makes; both kernels skip a problem that is
// not, so a batch's converged tiles cost nothing while its slowest one
// goes on.
//
// A process group's fit (models/kmeans.py) launches the two apart: the
// ranks add their partials between them, and the update kernel reads the
// sums as one block a problem and the farthest point of every rank's as
// a row of its own.
//
// Replaces no TPU kernel: the JAX package runs the step as XLA matmuls
// (rs_image_segmentation_tpu/models/kmeans.py: lloyd_step inside
// kmeans_fit_predict's while_loop), as the port's plain version does
// (models/kmeans.py::_lloyd, which CPU tensors take). Added because that
// plain version
// took 78 % of the KMeans batch: every iteration wrote and read a
// (B, N, K) distance tensor and a (B, N, K) one-hot, ran a cuBLAS product
// a problem whose 32 x 32 tiles ran mostly empty at K = 7 and F = 19, and
// made about 35 launches.
//
// What bounds it on an H100: bytes. An iteration must read the points
// once: (8, 360 000, 19) f32 is 218.9 MB, 65.3 us at 3.35 TB/s; its 0.82
// GFLOP (2 K F + F a point) take 12 us at 67 TFLOP/s. What holds the
// partials kernel back is the SM's work around each point read: K F
// products, a shared-memory broadcast of the centroids, the argmin, and a
// second pass over the staged points for the sums, each phase between two
// block barriers.
//
// What lloyd_partials_kernel does about it:
//   * Each point is read from device memory once. A block stages chunks of
//     kChunk points (38 912 contiguous bytes at F = 19) into shared memory
//     with 16-byte asynchronous copies. Rows keep an odd stride (F, or
//     F + 1 for an even F), so a thread reading its own point's row across
//     a warp hits 32 banks.
//   * A thread takes kPts points of a chunk, kThreads apart: their squared
//     norms and K dot products in registers (KMAX of them, unrolled: an
//     instance for k 7, the source's, since an unused register slot cost
//     8 %, and a generic one of kMaxK slots for every other k), four
//     features at a time, each 16-byte broadcast of a centroid's features
//     serving kPts points (with one point a thread, twice the broadcasts,
//     the pass took 0.153 ms, against 0.135); then d = (|x|^2 - 2 x.c) +
//     |c|^2 clamped at 0, the plain version's order, and the first index
//     of the smallest d.
//   * The sums without float atomics: the chunk's labels go to shared
//     memory as bytes, and thread (r, f) adds feature f of the points of
//     group r (kThreads / F groups of consecutive points) in order, a run
//     of equal labels in a register (a tile's pixels come in runs; four
//     labels read at once), into its own f64 slots (r, label, f) in shared
//     memory when the label changes; the counts likewise, in integers. At
//     the block's end the groups' slots are added in order. So every sum
//     has one order whatever the schedule: a rerun gives the same bits.
//     The partition of a problem's points into blocks depends on N alone,
//     so a problem's result does not depend on the batch around it.
//   * 53 KB of shared memory and 64 registers a thread at K = 7, F = 19:
//     four blocks of 256 threads an SM. A second chunk buffer, to prefetch
//     the next chunk, costs blocks an SM and was slower (with one point a
//     thread: 0.166 ms, against 0.153 with one buffer).
//
// lloyd_update_kernel reads the partials (B x ceil(N / kPointsPerBlock) x
// (K F f64 + K int32 + 8 bytes), 1.5 MB at the batch above), a warp an
// entry: its lanes load the entry's blocks 32 apart, kUpdateLoads at once,
// each adding its own in block order in f64, and one fixed shuffle tree
// adds the lanes, as the reference sums in f64 (perfbench/reference/
// kmeans.py). sum / count is rounded once to f32. The squared shift adds
// the f32 squares in f64 in a fixed tree.
//
// Every product but the dot products' is rounded on its own: the source
// builds with --fmad=false (ops/_build.py NO_FMA), as the plain version's
// elementwise terms round. The dot products accumulate with explicit
// fmaf, as the plain version's cuBLAS product does.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;               // threads a partials block
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;               // partials blocks an SM
constexpr int kPts = 2;                     // points a thread, a chunk
constexpr int kChunk = kThreads * kPts;     // points a chunk
constexpr int kPointsPerBlock = 2048;
constexpr int kChunksPerBlock = kPointsPerBlock / kChunk;
constexpr int kMaxK = 32;
constexpr int kMaxF = 64;
constexpr int kUpdateThreads = 1024;
constexpr int kUpdateWarps = kUpdateThreads / 32;
constexpr int kUpdateSlots = kMaxK * kMaxF / kUpdateThreads;
constexpr int kUpdateLoads = 8;             // partials a lane loads at once

// Offsets of the partials kernel's shared memory, in bytes.
struct Layout {
  int fs;       // a staged point's stride in floats: odd
  int f4;       // a centroid's row in floats, padded to a multiple of 4
  int groups;   // point groups of the sums' pass (kThreads / F)
  int per;      // points a group, a multiple of 4
  size_t acc, x, c, cn, lab, cnt, far_d, far_i, bytes;
};

__host__ __device__ inline size_t up16(size_t v) { return (v + 15) & ~size_t(15); }

__host__ __device__ inline Layout layout(int k, int f) {
  Layout L;
  L.fs = f | 1;
  L.f4 = (f + 3) & ~3;
  L.groups = kThreads / f;
  L.per = ((kChunk + L.groups - 1) / L.groups + 3) & ~3;
  size_t o = 0;
  L.acc = o;
  o = up16(o + static_cast<size_t>(L.groups) * k * f * sizeof(double));
  L.x = o;
  o = up16(o + static_cast<size_t>(kChunk) * L.fs * sizeof(float));
  L.c = o;
  o += static_cast<size_t>(k) * L.f4 * sizeof(float);
  L.cn = o;
  o += k * sizeof(float);
  L.cnt = o;
  o += static_cast<size_t>(L.groups) * k * sizeof(int);
  L.far_d = o;
  o += kWarps * sizeof(float);
  L.far_i = o;
  o = up16(o + kWarps * sizeof(int));
  L.lab = o;                                // a byte a point
  o += kChunk;
  L.bytes = o;
  return L;
}

__device__ inline bool active(const float* shift, const float* tol,
                              const long long* n_iter, long long max_iter,
                              int b) {
  return shift[b] > tol[b] && n_iter[b] < max_iter;
}

// (d, i) becomes the farther of itself and (od, oi): the larger distance,
// the lower index among equals. A total order, so any reduction tree gives
// the same answer.
__device__ inline void farther(float& d, int& i, float od, int oi) {
  if (od > d || (od == d && oi < i)) {
    d = od;
    i = oi;
  }
}

__device__ inline void warp_farthest(float& d, int& i) {
  for (int off = 16; off > 0; off >>= 1) {
    farther(d, i, __shfl_down_sync(0xffffffffu, d, off),
            __shfl_down_sync(0xffffffffu, i, off));
  }
}

// A warp's sum in lane 0, by one fixed tree.
template <typename T>
__device__ inline T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ inline void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src));
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying `count` floats of a chunk's rows at `src` into `xs`
// (stride fs): 16-byte asynchronous copies where the rows lie unpadded
// and `src` is aligned, the rest by the threads; one commit group.
__device__ inline void stage(const float* src, int count, int f, int fs,
                             float* xs) {
  const int t = threadIdx.x;
  if (fs == f && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = count >> 2;
    for (int i = t; i < n4; i += kThreads) cp_async16(xs + 4 * i, src + 4 * i);
    for (int i = (n4 << 2) + t; i < count; i += kThreads) xs[i] = __ldg(src + i);
  } else {
    for (int i = t; i < count; i += kThreads) {
      const int p = i / f;
      xs[p * fs + (i - p * f)] = __ldg(src + i);
    }
  }
  cp_async_commit();
}

// The sums' pass: one point of a group, feature gf, into the thread's run
// (a run of equal labels gathers in registers; pixels of a tile come in
// runs), which goes to the group's slot when the label changes.
__device__ inline void add_point(int label, float v, int gf, int f,
                                 double* slots, int* counts, int& cur,
                                 double& run, int& crun) {
  if (label != cur) {
    if (cur >= 0) {
      slots[cur * f] += run;
      if (gf == 0) counts[cur] += crun;
    }
    cur = label;
    run = 0.0;
    crun = 0;
  }
  run += static_cast<double>(v);
  ++crun;
}

// KMAX: the clusters a thread's registers hold; kExact: k == KMAX.
template <int KMAX, bool kExact>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
lloyd_partials_kernel(const float* __restrict__ x,
                      const float* __restrict__ cents,
                      const float* __restrict__ shift,
                      const float* __restrict__ tol,
                      const long long* __restrict__ n_iter,
                      long long max_iter, long long n, int k, int f,
                      int* __restrict__ flag,
                      double* __restrict__ part_sums,
                      int* __restrict__ part_counts,
                      float* __restrict__ part_far_d,
                      int* __restrict__ part_far_i) {
  const int b = blockIdx.y, t = threadIdx.x;
  // cleared here, set by the update kernel that follows on the stream
  if (b == 0 && blockIdx.x == 0 && t == 0) *flag = 0;
  if (!active(shift, tol, n_iter, max_iter, b)) return;

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(k, f);
  double* acc = reinterpret_cast<double*>(smem + L.acc);
  float* xs = reinterpret_cast<float*>(smem + L.x);
  float* cs = reinterpret_cast<float*>(smem + L.c);
  float* cn = reinterpret_cast<float*>(smem + L.cn);
  unsigned char* lab = smem + L.lab;
  int* cnt = reinterpret_cast<int*>(smem + L.cnt);

  const long long first = static_cast<long long>(blockIdx.x) * kPointsPerBlock;
  const long long left = n - first;
  const int chunks = static_cast<int>(
      left >= kPointsPerBlock ? kChunksPerBlock : (left + kChunk - 1) / kChunk);
  stage(x + (static_cast<size_t>(b) * n + first) * f,
        static_cast<int>(left < kChunk ? left : kChunk) * f, f, L.fs, xs);

  for (int i = t; i < L.groups * k * f; i += kThreads) acc[i] = 0.0;
  for (int i = t; i < L.groups * k; i += kThreads) cnt[i] = 0;
  const float* cb = cents + static_cast<size_t>(b) * k * f;
  for (int i = t; i < k * L.f4; i += kThreads) {
    const int kk = i / L.f4, ff = i - kk * L.f4;
    cs[i] = ff < f ? cb[kk * f + ff] : 0.f;
  }
  __syncthreads();
  if (t < k) {
    float s = 0.f;
    for (int ff = 0; ff < f; ++ff) s = s + cs[t * L.f4 + ff] * cs[t * L.f4 + ff];
    cn[t] = s;
  }

  float far_d = -1.f;       // this thread's farthest point so far
  int far_i = INT_MAX;
  const int gr = t / f, gf = t - gr * f;    // the sums' pass: group, feature
  double* slots = acc + static_cast<size_t>(gr) * k * f + gf;
  int* counts = cnt + gr * k;
  int cur = -1, crun = 0;
  double run = 0.0;
  for (int c = 0; c < chunks; ++c) {
    const long long p0 = first + static_cast<long long>(c) * kChunk;
    const int np = static_cast<int>(n - p0 < kChunk ? n - p0 : kChunk);
    if (c > 0) {        // the buffer is free: the last chunk's passes are done
      stage(x + (static_cast<size_t>(b) * n + p0) * f, np * f, f, L.fs, xs);
    }
    cp_async_wait();
    __syncthreads();

    // each point's nearest centroid: kPts points a thread, kThreads apart,
    // so that each centroid read serves kPts points
    float dot[kPts][KMAX], xn[kPts];
#pragma unroll
    for (int j = 0; j < kPts; ++j) {
      xn[j] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KMAX; ++kk) dot[j][kk] = 0.f;
    }
    for (int f0 = 0; f0 < f; f0 += 4) {
      float v[kPts][4];
#pragma unroll
      for (int j = 0; j < kPts; ++j) {
        const float* xr = xs + (t + j * kThreads) * L.fs + f0;
#pragma unroll
        for (int q = 0; q < 4; ++q) v[j][q] = f0 + q < f ? xr[q] : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) xn[j] = xn[j] + v[j][q] * v[j][q];
      }
#pragma unroll
      for (int kk = 0; kk < KMAX; ++kk) {
        if (kExact || kk < k) {
          const float4 c4 = *reinterpret_cast<const float4*>(
              cs + kk * L.f4 + f0);
#pragma unroll
          for (int j = 0; j < kPts; ++j) {
            dot[j][kk] = __fmaf_rn(v[j][0], c4.x, dot[j][kk]);
            dot[j][kk] = __fmaf_rn(v[j][1], c4.y, dot[j][kk]);
            dot[j][kk] = __fmaf_rn(v[j][2], c4.z, dot[j][kk]);
            dot[j][kk] = __fmaf_rn(v[j][3], c4.w, dot[j][kk]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPts; ++j) {
      const int q = t + j * kThreads;
      if (q < np) {
        int label = 0;
        float best = 0.f;
#pragma unroll
        for (int kk = 0; kk < KMAX; ++kk) {
          if (kExact || kk < k) {
            float d = (xn[j] - 2.f * dot[j][kk]) + cn[kk];
            d = d < 0.f ? 0.f : d;
            if (kk == 0 || d < best) {
              best = d;
              label = kk;
            }
          }
        }
        lab[q] = static_cast<unsigned char>(label);
        if (best > far_d) {     // a thread's points come in rising order
          far_d = best;
          far_i = static_cast<int>(p0 + q);
        }
      }
    }
    __syncthreads();

    // the chunk's sums and counts, each group's points in order, four
    // labels read at once; four points of the current run added together
    if (gr < L.groups) {
      const int lo = gr * L.per;
      const int hi = lo + L.per < np ? lo + L.per : np;
      int p = lo;
      for (; p + 4 <= hi; p += 4) {
        const unsigned l4 = *reinterpret_cast<const unsigned*>(lab + p);
        const float* xp = xs + p * L.fs + gf;
        const float a0 = xp[0], a1 = xp[L.fs], a2 = xp[2 * L.fs],
                    a3 = xp[3 * L.fs];
        if (cur >= 0 && l4 == static_cast<unsigned>(cur) * 0x01010101u) {
          run += (static_cast<double>(a0) + static_cast<double>(a1))
                 + (static_cast<double>(a2) + static_cast<double>(a3));
          crun += 4;
        } else {
          add_point(l4 & 255, a0, gf, f, slots, counts, cur, run, crun);
          add_point(l4 >> 8 & 255, a1, gf, f, slots, counts, cur, run, crun);
          add_point(l4 >> 16 & 255, a2, gf, f, slots, counts, cur, run, crun);
          add_point(l4 >> 24, a3, gf, f, slots, counts, cur, run, crun);
        }
      }
      for (; p < hi; ++p) {
        add_point(lab[p], xs[p * L.fs + gf], gf, f, slots, counts, cur, run,
                  crun);
      }
    }
    __syncthreads();
  }
  if (gr < L.groups && cur >= 0) {
    slots[cur * f] += run;
    if (gf == 0) counts[cur] += crun;
  }
  __syncthreads();

  // the block's partials, its groups added in order; laid out (problem,
  // entry, block) so the update kernel reads each entry's blocks in a row
  const int blocks = gridDim.x, g = blockIdx.x;
  const int kf = k * f;
  for (int i = t; i < kf; i += kThreads) {
    double s = 0.0;
    for (int r = 0; r < L.groups; ++r) s += acc[static_cast<size_t>(r) * kf + i];
    part_sums[(static_cast<size_t>(b) * kf + i) * blocks + g] = s;
  }
  for (int i = t; i < k; i += kThreads) {
    int s = 0;
    for (int r = 0; r < L.groups; ++r) s += cnt[r * k + i];
    part_counts[(static_cast<size_t>(b) * k + i) * blocks + g] = s;
  }
  float* wd = reinterpret_cast<float*>(smem + L.far_d);
  int* wi = reinterpret_cast<int*>(smem + L.far_i);
  warp_farthest(far_d, far_i);
  if ((t & 31) == 0) {
    wd[t >> 5] = far_d;
    wi[t >> 5] = far_i;
  }
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < kWarps; ++w) farther(far_d, far_i, wd[w], wi[w]);
    part_far_d[static_cast<size_t>(b) * blocks + g] = far_d;
    part_far_i[static_cast<size_t>(b) * blocks + g] = far_i;
  }
}

__global__ void __launch_bounds__(kUpdateThreads)
lloyd_update_kernel(const float* __restrict__ src, long long src_n,
                    float* __restrict__ cents, float* __restrict__ shift,
                    const float* __restrict__ tol,
                    long long* __restrict__ n_iter, long long max_iter,
                    int k, int f, int blocks,
                    const double* __restrict__ part_sums,
                    const int* __restrict__ part_counts,
                    const float* __restrict__ part_far_d,
                    const int* __restrict__ part_far_i,
                    int* __restrict__ flag) {
  const int b = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  if (!active(shift, tol, n_iter, max_iter, b)) return;
  __shared__ double sums[kMaxK * kMaxF];
  __shared__ long long counts[kMaxK];
  __shared__ double red[kUpdateWarps];
  __shared__ int far_at;
  const int kf = k * f;

  // a warp an entry: its lanes read the entry's blocks 32 apart, each in
  // order, and one fixed tree adds the lanes
  for (int e = warp; e <= kf + k; e += kUpdateWarps) {
    if (e < kf) {
      const double* p = part_sums + (static_cast<size_t>(b) * kf + e) * blocks;
      double s = 0.0;
      for (int g0 = lane; g0 < blocks; g0 += 32 * kUpdateLoads) {
        double v[kUpdateLoads];       // in flight together, added in order
#pragma unroll
        for (int j = 0; j < kUpdateLoads; ++j) {
          v[j] = g0 + 32 * j < blocks ? p[g0 + 32 * j] : 0.0;
        }
#pragma unroll
        for (int j = 0; j < kUpdateLoads; ++j) s += v[j];
      }
      s = warp_sum(s);
      if (lane == 0) sums[e] = s;
    } else if (e < kf + k) {
      const int* p = part_counts
          + (static_cast<size_t>(b) * k + (e - kf)) * blocks;
      long long s = 0;
      for (int g0 = lane; g0 < blocks; g0 += 32 * kUpdateLoads) {
        int v[kUpdateLoads];
#pragma unroll
        for (int j = 0; j < kUpdateLoads; ++j) {
          v[j] = g0 + 32 * j < blocks ? p[g0 + 32 * j] : 0;
        }
#pragma unroll
        for (int j = 0; j < kUpdateLoads; ++j) s += v[j];
      }
      s = warp_sum(s);
      if (lane == 0) counts[e - kf] = s;
    } else {
      float d = -1.f;
      int i = INT_MAX;
      const float* pd = part_far_d + static_cast<size_t>(b) * blocks;
      const int* pi = part_far_i + static_cast<size_t>(b) * blocks;
      for (int g0 = lane; g0 < blocks; g0 += 32 * kUpdateLoads) {
        float vd[kUpdateLoads];
        int vi[kUpdateLoads];
#pragma unroll
        for (int j = 0; j < kUpdateLoads; ++j) {
          const bool in = g0 + 32 * j < blocks;
          vd[j] = in ? pd[g0 + 32 * j] : -1.f;
          vi[j] = in ? pi[g0 + 32 * j] : INT_MAX;
        }
#pragma unroll
        for (int j = 0; j < kUpdateLoads; ++j) farther(d, i, vd[j], vi[j]);
      }
      warp_farthest(d, i);
      if (lane == 0) far_at = i;
    }
  }
  __syncthreads();

  const float* cb = cents + static_cast<size_t>(b) * kf;
  float fresh[kUpdateSlots];
  double sq = 0.0;
#pragma unroll
  for (int e = 0; e < kUpdateSlots; ++e) {
    const int idx = t + e * kUpdateThreads;
    if (idx < kf) {
      const int kk = idx / f;
      const long long c = counts[kk];
      const float nc = c > 0
          ? static_cast<float>(sums[idx] / static_cast<double>(c))
          : src[(static_cast<size_t>(b) * src_n + far_at) * f
                + (idx - kk * f)];
      const float dd = nc - cb[idx];
      sq += static_cast<double>(dd * dd);
      fresh[e] = nc;
    }
  }
  sq = warp_sum(sq);
  if (lane == 0) red[warp] = sq;
  __syncthreads();

  float* out = cents + static_cast<size_t>(b) * kf;
#pragma unroll
  for (int e = 0; e < kUpdateSlots; ++e) {
    const int idx = t + e * kUpdateThreads;
    if (idx < kf) out[idx] = fresh[e];
  }
  if (t == 0) {
    double s = 0.0;
    for (int w = 0; w < kUpdateWarps; ++w) s += red[w];
    const float step = static_cast<float>(s);
    const long long it = n_iter[b] + 1;
    shift[b] = step;
    n_iter[b] = it;
    if (step > tol[b] && it < max_iter) atomicOr(flag, 1);
  }
}

using PartialsKernel = void (*)(const float*, const float*, const float*,
                                const float*, const long long*, long long,
                                long long, int, int, int*, double*, int*,
                                float*, int*);

int partials(const float* x, const float* cents, const float* shift,
             const float* tol, const long long* n_iter, long long max_iter,
             int batch, long long n, int k, int f, int blocks,
             double* part_sums, int* part_counts, float* part_far_d,
             int* part_far_i, int* flag, cudaStream_t s) {
  if (batch < 1 || batch > 65535 || n < 1 || n > INT_MAX || k < 1
      || k > kMaxK || f < 1 || f > kMaxF
      || blocks != (n + kPointsPerBlock - 1) / kPointsPerBlock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // k 7, the source's KMeans, has registers for its clusters alone; every
  // other k takes the generic instance's kMaxK slots
  const PartialsKernel kernel = k == 7
      ? &lloyd_partials_kernel<7, true>
      : &lloyd_partials_kernel<kMaxK, false>;
  const size_t smem = layout(k, f).bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(blocks, batch), kThreads, smem, s>>>(
      x, cents, shift, tol, n_iter, max_iter, n, k, f, flag, part_sums,
      part_counts, part_far_d, part_far_i);
  return static_cast<int>(cudaGetLastError());
}

int update(const float* src, long long src_n, float* cents, float* shift,
           const float* tol, long long* n_iter, long long max_iter, int batch,
           int k, int f, int blocks, const double* part_sums,
           const int* part_counts, const float* part_far_d,
           const int* part_far_i, int* flag, cudaStream_t s) {
  if (batch < 1 || batch > 65535 || src_n < 1 || k < 1 || k > kMaxK || f < 1
      || f > kMaxF || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  lloyd_update_kernel<<<batch, kUpdateThreads, 0, s>>>(
      src, src_n, cents, shift, tol, n_iter, max_iter, k, f, blocks,
      part_sums, part_counts, part_far_d, part_far_i, flag);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The partials kernel alone, on `stream`. `blocks` is ceil(n /
// kPointsPerBlock) (ops/kernels.py mirrors kPointsPerBlock, kMaxK and
// kMaxF); the partials hold batch * blocks entries, laid out (batch, K F,
// blocks), (batch, K, blocks), (batch, blocks) and (batch, blocks). It
// clears `flag`.
extern "C" int lloyd_partials_launch(const void* x, const void* cents,
                                     const void* shift, const void* tol,
                                     const void* n_iter, long long max_iter,
                                     int batch, long long n, int k, int f,
                                     int blocks, void* part_sums,
                                     void* part_counts, void* part_far_d,
                                     void* part_far_i, void* flag,
                                     void* stream) {
  return partials(static_cast<const float*>(x),
                  static_cast<const float*>(cents),
                  static_cast<const float*>(shift),
                  static_cast<const float*>(tol),
                  static_cast<const long long*>(n_iter), max_iter, batch, n,
                  k, f, blocks, static_cast<double*>(part_sums),
                  static_cast<int*>(part_counts),
                  static_cast<float*>(part_far_d),
                  static_cast<int*>(part_far_i), static_cast<int*>(flag),
                  static_cast<cudaStream_t>(stream));
}

// The update kernel alone, on `stream`, from `blocks` partials a problem
// laid out as above: an empty cluster takes row part_far_i of the
// problem's (src_n, F) rows of `src`. A process group's fit passes the
// partials of every rank, summed into one block, and the farthest point
// of them all as a row of its own.
extern "C" int lloyd_update_launch(const void* src, long long src_n,
                                   void* cents, void* shift, const void* tol,
                                   void* n_iter, long long max_iter,
                                   int batch, int k, int f, int blocks,
                                   const void* part_sums,
                                   const void* part_counts,
                                   const void* part_far_d,
                                   const void* part_far_i, void* flag,
                                   void* stream) {
  return update(static_cast<const float*>(src), src_n,
                static_cast<float*>(cents), static_cast<float*>(shift),
                static_cast<const float*>(tol),
                static_cast<long long*>(n_iter), max_iter, batch, k, f,
                blocks, static_cast<const double*>(part_sums),
                static_cast<const int*>(part_counts),
                static_cast<const float*>(part_far_d),
                static_cast<const int*>(part_far_i), static_cast<int*>(flag),
                static_cast<cudaStream_t>(stream));
}

// One Lloyd iteration: the partials kernel, then the update kernel, on
// `stream`, an empty cluster taking the problem's farthest point of `x`.
extern "C" int lloyd_pass_launch(const void* x, void* cents, void* shift,
                                 const void* tol, void* n_iter,
                                 long long max_iter, int batch, long long n,
                                 int k, int f, int blocks, void* part_sums,
                                 void* part_counts, void* part_far_d,
                                 void* part_far_i, void* flag, void* stream) {
  const int e = lloyd_partials_launch(x, cents, shift, tol, n_iter, max_iter,
                                      batch, n, k, f, blocks, part_sums,
                                      part_counts, part_far_d, part_far_i,
                                      flag, stream);
  if (e != 0) return e;
  return lloyd_update_launch(x, n, cents, shift, tol, n_iter, max_iter,
                             batch, k, f, blocks, part_sums, part_counts,
                             part_far_d, part_far_i, flag, stream);
}
