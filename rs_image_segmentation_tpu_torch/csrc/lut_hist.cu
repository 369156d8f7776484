// lut_hist: per-band 256-entry uint8 table applied to a uint8 scene, with
// an optional int32 histogram of the stretched values. The file also holds
// raw_counts (raw_counts_kernel, raw_counts_launch; its note is at the
// kernel), the 256-bin counts of the raw DNs by the same ranges body.
//
// Replaces: rs_image_segmentation_tpu/ops/pallas_kernels.py
//   lut_hist_pallas (kernel bodies _lut_hist_kernel, _lut_hist_mixed_kernel).
//   The mixed body's fixed-point arithmetic spared the TPU a gather; here
//   every band is served from the table, one shared-memory load a lookup.
//
// What bounds it on an H100: bytes. It reads each scene byte once and
// writes one f32 (or u8) per byte, with a handful of integer ops per
// pixel: at the main-path shape (8 x 7 x 600 x 600, f32 out) that is
// 20.2 MB in + 80.6 MB out, about 30 us at 3.35 TB/s. Four fifths of the
// bytes are the f32 stores.
//
// What held the first design back: a thread turned one 16-byte load into
// four float4 stores 64 bytes apart, so each store instruction of a warp
// wrote a quarter of every line it touched; a thread had about one load
// in flight; one block column per plane made 4 928 small blocks, each
// filling a table and passing a barrier for 4 KB of input; every lookup
// was a byte load and a convert.
//
// What the design does about it:
//   * Words. A thread loads 4 consecutive DNs as one 32-bit word and
//     writes their 4 levels as one float4: a warp reads 128 contiguous
//     bytes and writes 512 per instruction, whole lines. With uint8 out a
//     thread moves 16 DNs, one 16-byte load and one 16-byte store.
//   * A grid sized to the card: LUT_BLOCKS_PER_SM blocks an SM
//     (ops/kernels.py::lut_hist_plan), each streaming one contiguous
//     range of `span` words of the flat (planes x n) scene, kUnroll
//     independent loads in flight per thread before the first lookup.
//   * A block stages the tables of the planes its range touches (two at
//     the main path's shape) in shared memory as 32-bit entries, f32 for
//     f32 out, so a lookup is one 32-bit shared load and no convert. A
//     range touches at most kMaxTables planes (the plan's cap on span).
//   * Plane lengths that are not a multiple of the unit: the units wholly
//     inside a plane take the vector route; the one unit that straddles a
//     plane boundary is done byte by byte. Bases that are not aligned for
//     the unit, or planes shorter than it, take a smaller unit, down to
//     the scalar instance (one byte a unit). No padding.
//   * The histogram: each warp counts into its own 256 bins in shared
//     memory, and a thread adds each distinct value of its word once with
//     the count of its repeats, so smooth regions, where the four pixels
//     of a word mostly share a level, do not serialise on one bin.
//     Planes that split into whole units take the cluster instance
//     (lut_hist_cluster_kernel): one cluster of kCluster blocks per plane
//     sums its blocks' bins through distributed shared memory and writes
//     each bin once, so the output needs no zero fill and the call is one
//     launch. Other shapes take the ranges kernel with kHist: at the end of
//     each plane a block adds each nonzero bin of its warps' sums into the
//     zeroed (planes, 256) output with one global atomic, and bytes of
//     straddling words add into it directly. Integer sums are exact in any
//     order. ops/kernels.py::lut_hist_instance picks the instance.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;      // LUT_THREADS; == the bins a thread sums
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;         // LUT_UNROLL: loads in flight per thread
constexpr int kMaxTables = 32;     // LUT_MAX_TABLES: tables a block stages
constexpr int kCluster = 16;       // LUT_CLUSTER: blocks a plane (cluster)
constexpr int kBinsPerRank = 256 / kCluster;

// A table entry: f32 when the output is f32 and no bin is needed, else
// the level as an integer.
template <bool kOutU8, bool kHist>
using Entry =
    typename std::conditional<kOutU8 || kHist, uint32_t, float>::type;

// One shared atomic per distinct value of a word, with its repeat count.
__device__ __forceinline__ void count_word(int* bins, uint32_t a, uint32_t b,
                                          uint32_t c, uint32_t d) {
  atomicAdd(bins + a, 1 + (b == a) + (c == a) + (d == a));
  if (b != a) atomicAdd(bins + b, 1 + (c == b) + (d == b));
  if (c != a && c != b) atomicAdd(bins + c, 1 + (d == c));
  if (d != a && d != b && d != c) atomicAdd(bins + d, 1);
}

template <int kW> struct Unit;
template <> struct Unit<16> { using type = uint4; };
template <> struct Unit<4> { using type = uint32_t; };
template <> struct Unit<1> { using type = uint8_t; };

// A DN's level: its table entry, or (kRaw, the raw counts) the DN.
template <bool kRaw, typename E>
__device__ __forceinline__ E level(const E* tab, uint32_t dn) {
  if constexpr (kRaw) {
    return static_cast<E>(dn);
  } else {
    return tab[dn];
  }
}

// The levels of a word's 4 DNs as one word of bytes (uint8 out).
template <bool kHist, bool kRaw>
__device__ __forceinline__ uint32_t word_u8(const uint32_t* tab, int* bins,
                                            uint32_t v) {
  const uint32_t t0 = level<kRaw>(tab, v & 0xff);
  const uint32_t t1 = level<kRaw>(tab, (v >> 8) & 0xff);
  const uint32_t t2 = level<kRaw>(tab, (v >> 16) & 0xff);
  const uint32_t t3 = level<kRaw>(tab, v >> 24);
  if constexpr (kHist) count_word(bins, t0, t1, t2, t3);
  return t0 | (t1 << 8) | (t2 << 16) | (t3 << 24);
}

// Level t of pixel j to the output; the raw counts store nothing.
template <bool kOutU8, bool kRaw, typename E>
__device__ __forceinline__ void store(void* out, long long j, E t) {
  if constexpr (kRaw) {
    return;
  } else if constexpr (kOutU8) {
    static_cast<uint8_t*>(out)[j] = static_cast<uint8_t>(t);
  } else {
    static_cast<float*>(out)[j] = static_cast<float>(t);
  }
}

// Unit i (kW pixels from pixel kW * i) through the table `tab`; with kRaw
// (uint8 instances only) the raw DNs are counted and nothing is stored.
template <int kW, bool kOutU8, bool kHist, bool kRaw, typename E>
__device__ __forceinline__ void put(const E* tab, int* bins,
                                    typename Unit<kW>::type v, void* out,
                                    long long i) {
  if constexpr (kW == 16) {         // uint8 out only
    const uint4 w = make_uint4(word_u8<kHist, kRaw>(tab, bins, v.x),
                               word_u8<kHist, kRaw>(tab, bins, v.y),
                               word_u8<kHist, kRaw>(tab, bins, v.z),
                               word_u8<kHist, kRaw>(tab, bins, v.w));
    if constexpr (!kRaw) static_cast<uint4*>(out)[i] = w;
  } else if constexpr (kW == 4 && kOutU8) {
    const uint32_t w = word_u8<kHist, kRaw>(tab, bins, v);
    if constexpr (!kRaw) static_cast<uint32_t*>(out)[i] = w;
  } else if constexpr (kW == 4) {
    const E t0 = tab[v & 0xff], t1 = tab[(v >> 8) & 0xff];
    const E t2 = tab[(v >> 16) & 0xff], t3 = tab[v >> 24];
    if constexpr (kHist) count_word(bins, t0, t1, t2, t3);
    static_cast<float4*>(out)[i] =
        make_float4(static_cast<float>(t0), static_cast<float>(t1),
                    static_cast<float>(t2), static_cast<float>(t3));
  } else {
    const E t = level<kRaw>(tab, v);
    if constexpr (kHist) atomicAdd(bins + t, 1);
    store<kOutU8, kRaw>(out, i, t);
  }
}

// The ranges instance's body: lut_hist_kernel, and raw_counts_kernel with
// kRaw (no table staged, nothing stored, the raw DNs counted into hist).
template <int kW, bool kOutU8, bool kHist, bool kRaw>
__device__ __forceinline__ void
ranges_body(const uint8_t* __restrict__ scene,
            const uint8_t* __restrict__ lut, void* __restrict__ out,
            int32_t* __restrict__ hist, long long planes, long long n,
            long long units, long long span) {
  using E = Entry<kOutU8, kHist>;
  using U = typename Unit<kW>::type;
  extern __shared__ uint32_t s_tab_words[];      // tables of planes p0..p1
  E* s_tab = reinterpret_cast<E*>(s_tab_words);
  __shared__ int s_bins[kHist ? kWarps : 1][256];

  const long long total = planes * n;
  const long long lo = blockIdx.x * span;
  const long long hi = lo + span < units ? lo + span : units;
  const long long end_px = hi * kW < total ? hi * kW : total;
  const long long p0 = lo * kW / n;
  const long long p1 = (end_px - 1) / n;
  if constexpr (!kRaw) {
    for (long long i = threadIdx.x; i < (p1 - p0 + 1) * 256;
         i += kThreads) {
      s_tab[i] = static_cast<E>(lut[p0 * 256 + i]);
    }
  }
  if constexpr (kHist) {
    for (int i = threadIdx.x; i < kWarps * 256; i += kThreads) {
      (&s_bins[0][0])[i] = 0;
    }
  }
  __syncthreads();

  int* bins = kHist ? s_bins[threadIdx.x / 32] : nullptr;
  const U* src = reinterpret_cast<const U*>(scene);
  for (long long p = p0; p <= p1; ++p) {
    const E* tab = s_tab + (p - p0) * 256;
    // the units wholly inside plane p, within this block's range
    const long long first = (p * n + kW - 1) / kW;
    const long long last = (p + 1) * n / kW;
    const long long ws = first > lo ? first : lo;
    const long long we = last < hi ? last : hi;
    for (long long base = ws + threadIdx.x; base < we;
         base += kThreads * kUnroll) {
      U v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + u * kThreads;
        if (i < we) v[u] = src[i];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + u * kThreads;
        if (i < we) put<kW, kOutU8, kHist, kRaw>(tab, bins, v[u], out, i);
      }
    }
    if constexpr (kHist) {         // plane p's counts: one atomic a bin
      __syncthreads();
      int sum = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        sum += s_bins[w][threadIdx.x];
        s_bins[w][threadIdx.x] = 0;
      }
      if (sum) atomicAdd(&hist[p * 256 + threadIdx.x], sum);
      __syncthreads();
    }
  }

  // the word that straddles each plane boundary in this range (and the
  // scene's last, partial word), byte by byte
  if (kW > 1 && n % kW != 0) {
    for (long long p = p0 + 1 + threadIdx.x; p <= p1 + 1; p += kThreads) {
      const long long b = p * n;               // first pixel of plane p
      const long long w = b / kW;
      if (b % kW == 0 || w < lo || w >= hi) continue;
      const long long stop = w * kW + kW < total ? w * kW + kW : total;
      for (long long j = w * kW; j < stop; ++j) {
        const long long q = j < b ? p - 1 : p;
        const E t = level<kRaw>(s_tab + (q - p0) * 256, scene[j]);
        if constexpr (kHist) {
          atomicAdd(&hist[q * 256 + static_cast<int>(t)], 1);
        }
        store<kOutU8, kRaw>(out, j, t);
      }
    }
  }
}

template <int kW, bool kOutU8, bool kHist>
__global__ void __launch_bounds__(kThreads)
lut_hist_kernel(const uint8_t* __restrict__ scene,
                const uint8_t* __restrict__ lut, void* __restrict__ out,
                int32_t* __restrict__ hist, long long planes, long long n,
                long long units, long long span) {
  ranges_body<kW, kOutU8, kHist, false>(scene, lut, out, hist, planes, n,
                                        units, span);
}

// The histogram's cluster instance: one cluster of kCluster blocks per
// plane (blockIdx.y); block r streams the plane's units [r * span,
// (r + 1) * span) into its warps' bins, sums them, and after a cluster
// barrier writes bins [r * 16, r * 16 + 16) of the plane, summed over the
// cluster's blocks through distributed shared memory: every bin written
// once, so the output needs no zero fill. Planes of n % kW == 0 only.
template <int kW, bool kOutU8>
__global__ void __launch_bounds__(kThreads)
lut_hist_cluster_kernel(const uint8_t* __restrict__ scene,
                        const uint8_t* __restrict__ lut,
                        void* __restrict__ out, int32_t* __restrict__ hist,
                        long long n, long long span) {
  using U = typename Unit<kW>::type;
  __shared__ uint32_t s_tab[256];
  __shared__ int s_bins[kWarps][256];
  __shared__ int s_sum[256];
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long p = blockIdx.y;
  s_tab[threadIdx.x] = lut[p * 256 + threadIdx.x];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s_bins[w][threadIdx.x] = 0;
  __syncthreads();

  const long long end = (p + 1) * (n / kW);
  const long long lo = p * (n / kW) + rank * span;
  const long long hi = lo + span < end ? lo + span : end;
  int* bins = s_bins[threadIdx.x / 32];
  const U* src = reinterpret_cast<const U*>(scene);
  for (long long base = lo + threadIdx.x; base < hi;
       base += kThreads * kUnroll) {
    U v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads;
      if (i < hi) v[u] = src[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads;
      if (i < hi) put<kW, kOutU8, true, false>(s_tab, bins, v[u], out, i);
    }
  }
  __syncthreads();
  int sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) sum += s_bins[w][threadIdx.x];
  s_sum[threadIdx.x] = sum;
  cluster.sync();                      // every block's sums are in place
  if (threadIdx.x < kBinsPerRank) {
    const int bin = rank * kBinsPerRank + threadIdx.x;
    int total = 0;
#pragma unroll
    for (int q = 0; q < kCluster; ++q) {
      total += cluster.map_shared_rank(s_sum, q)[bin];
    }
    hist[p * 256 + bin] = total;
  }
  cluster.sync();                      // no block leaves while others read
}

template <int kW, bool kOutU8>
cudaError_t launch_cluster(long long planes, cudaStream_t stream,
                           const uint8_t* scene, const uint8_t* lut,
                           void* out, int32_t* hist, long long n,
                           long long span) {
  auto kernel = lut_hist_cluster_kernel<kW, kOutU8>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  static unsigned long long ready = 0;   // a bit per device: attribute set
  if (err == cudaSuccess && !(ready >> (dev & 63) & 1)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess) ready |= 1ull << (dev & 63);
  }
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, static_cast<unsigned>(planes));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, scene, lut, out, hist, n, span);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int kW, bool kOutU8, bool kHist>
cudaError_t launch(long long grid, size_t smem, cudaStream_t stream,
                   const uint8_t* scene, const uint8_t* lut, void* out,
                   int32_t* hist, long long planes, long long n,
                   long long units, long long span) {
  lut_hist_kernel<kW, kOutU8, kHist>
      <<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
          scene, lut, out, hist, planes, n, units, span);
  return cudaGetLastError();
}

template <bool kOutU8, bool kHist>
cudaError_t launch_unit(int unit, long long grid, size_t smem,
                        cudaStream_t s, const uint8_t* sc, const uint8_t* lt,
                        void* out, int32_t* h, long long planes, long long n,
                        long long units, long long span) {
  if constexpr (kOutU8) {
    if (unit == 16) {
      return launch<16, true, kHist>(grid, smem, s, sc, lt, out, h, planes,
                                     n, units, span);
    }
  }
  return unit == 4
      ? launch<4, kOutU8, kHist>(grid, smem, s, sc, lt, out, h, planes, n,
                                 units, span)
      : launch<1, kOutU8, kHist>(grid, smem, s, sc, lt, out, h, planes, n,
                                 units, span);
}

// ---------------------------------------------------------------------
// raw_counts: the 256-bin counts of each plane of a uint8 chunk's raw DNs,
// added into a caller-owned (planes, 256) int32 accumulator. It writes no
// output plane.
//
// Replaces: no TPU kernel. The JAX package counts the raw DNs on the host
// (pipeline/preprocess.py::build_stretch_stats). It was added because those
// host statistics were the streamed 36 MP scene's largest phase
// (pipeline/large_scene.py::classify_large_scene_streamed), which copies
// every raw chunk to the card anyway; every stretch table follows from the
// counts (pipeline/preprocess.py::stretch_stats_from_counts).
//
// What bounds it on an H100: bytes. It reads each byte once and adds 1 KB a
// plane: 21.2 MB a (7, 504, 6000) chunk, 6.3 us at 3.35 TB/s; 254 MB, 75.8
// us, a 7 x 6000 x 6000 scene.
//
// What the design does about it: it is lut_hist's ranges instance
// (ranges_body) with no table and no output: the blocks of
// ops/kernels.py::lut_hist_plan, kUnroll 16-byte loads in flight a thread,
// warp-private shared bins with a word's equal bytes added once
// (count_word), one global atomic a nonzero bin at the end of each plane.
// Integer sums are exact in any order, so calls over a scene's chunks add
// into one accumulator. A kernel of its own name, so that a trace tells
// its time from lut_hist's.
template <int kW>
__global__ void __launch_bounds__(kThreads)
raw_counts_kernel(const uint8_t* __restrict__ scene,
                  int32_t* __restrict__ counts, long long planes,
                  long long n, long long units, long long span) {
  ranges_body<kW, true, true, true>(scene, nullptr, nullptr, counts, planes,
                                    n, units, span);
}

}  // namespace

// scene: (planes, n) uint8; lut: (planes, 256) uint8; out: (planes, n) f32
// or uint8 (out_u8 != 0); hist: (planes, 256) int32, or null to skip the
// histogram. unit: the pixels a thread moves at a time
// (ops/kernels.py::lut_hist_unit): 16 (uint8 out, both bases 16-byte
// aligned), 4 (scene 4-byte aligned, out 16-byte aligned, or 4-byte
// aligned for uint8 out) or 1, with n >= unit. cluster != 0 takes the
// histogram's cluster instance (unit 4 or 16, n % unit == 0, planes <=
// 65535, span = ceil(n / unit / kCluster)), which writes every bin; else
// span is the units of the flat scene each block takes, at most
// (kMaxTables - 1) * n / unit (ops/kernels.py::lut_hist_plan), and hist
// must be zero-filled. Returns the cudaError_t of the launch.
extern "C" int lut_hist_launch(const void* scene, const void* lut, void* out,
                               void* hist, int out_u8, long long planes,
                               long long n, int unit, long long span,
                               int cluster, void* stream) {
  const uintptr_t sc = reinterpret_cast<uintptr_t>(scene);
  const uintptr_t ot = reinterpret_cast<uintptr_t>(out);
  const bool unit_ok = unit == 1
      || (unit == 4 && sc % 4 == 0 && ot % (out_u8 ? 4 : 16) == 0)
      || (unit == 16 && out_u8 && sc % 16 == 0 && ot % 16 == 0);
  if (planes <= 0 || n <= 0 || span <= 0 || !unit_ok || n < unit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto scp = static_cast<const uint8_t*>(scene);
  auto lt = static_cast<const uint8_t*>(lut);
  auto h = static_cast<int32_t*>(hist);
  if (cluster) {
    const long long per = n / unit;
    if (!h || unit == 1 || n % unit != 0 || planes > 65535
        || span != (per + kCluster - 1) / kCluster) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err;
    if (unit == 16) {
      err = launch_cluster<16, true>(planes, s, scp, lt, out, h, n, span);
    } else if (out_u8) {
      err = launch_cluster<4, true>(planes, s, scp, lt, out, h, n, span);
    } else {
      err = launch_cluster<4, false>(planes, s, scp, lt, out, h, n, span);
    }
    return static_cast<int>(err);
  }
  if (span * unit > (kMaxTables - 1) * n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long units = (planes * n + unit - 1) / unit;
  const long long grid = (units + span - 1) / span;
  const long long tables = (span * unit - 1) / n + 2;
  const size_t smem = static_cast<size_t>(tables < planes ? tables : planes)
                      * 256 * sizeof(uint32_t);
  cudaError_t err;
  if (out_u8) {
    err = h ? launch_unit<true, true>(unit, grid, smem, s, scp, lt, out, h,
                                      planes, n, units, span)
            : launch_unit<true, false>(unit, grid, smem, s, scp, lt, out, h,
                                       planes, n, units, span);
  } else {
    err = h ? launch_unit<false, true>(unit, grid, smem, s, scp, lt, out, h,
                                       planes, n, units, span)
            : launch_unit<false, false>(unit, grid, smem, s, scp, lt, out, h,
                                        planes, n, units, span);
  }
  return static_cast<int>(err);
}

// scene: (planes, n) uint8; counts: (planes, 256) int32, added into.
// unit: the pixels a thread reads at a time (ops/kernels.py::lut_hist_unit
// with no output): 16 (scene 16-byte aligned), 4 (4-byte aligned) or 1,
// with n >= unit; span as lut_hist_launch's ranges instance. Returns the
// cudaError_t of the launch.
extern "C" int raw_counts_launch(const void* scene, void* counts,
                                 long long planes, long long n, int unit,
                                 long long span, void* stream) {
  const uintptr_t sc = reinterpret_cast<uintptr_t>(scene);
  const bool unit_ok = unit == 1 || (unit == 4 && sc % 4 == 0)
      || (unit == 16 && sc % 16 == 0);
  if (!scene || !counts || planes <= 0 || n <= 0 || span <= 0 || !unit_ok
      || n < unit || span * unit > (kMaxTables - 1) * n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long units = (planes * n + unit - 1) / unit;
  const long long grid = (units + span - 1) / span;
  auto s = static_cast<cudaStream_t>(stream);
  auto scp = static_cast<const uint8_t*>(scene);
  auto h = static_cast<int32_t*>(counts);
  if (unit == 16) {
    raw_counts_kernel<16><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        scp, h, planes, n, units, span);
  } else if (unit == 4) {
    raw_counts_kernel<4><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        scp, h, planes, n, units, span);
  } else {
    raw_counts_kernel<1><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        scp, h, planes, n, units, span);
  }
  return static_cast<int>(cudaGetLastError());
}
