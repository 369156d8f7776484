// forest_labels: GemmForest predict over channel-major features,
// (B, F, N) f32 -> (B, N) int32 class labels.
//
// Replaces: rs_image_segmentation_tpu/ops/pallas_kernels.py
//   forest_labels_pallas (kernel bodies _forest_kernel,
//   _forest_grouped_kernel; sizing forest_block_n, _plan_pads).
//
// Semantics (pipeline/turbo.py gemm_labels_cm): node m decides
// s = (x[feature[m]] <= thr[m]) ? +1 : -1; leaf l fires iff every
// decision on its path agrees with the path's sign (votes == path_len);
// total[c] = sum over fired leaves of leaf_dist[l][c], times inv_trees;
// the label is classes[first index of the maximum total].
//
// What bounds it on an H100: at the main path's shape (8 x 19 x 360 000
// f32, the bundled scale's forest of 100 trees, 694 leaves, 4 classes) the
// least time is set by bytes (19 f32 read and one int32 written per pixel,
// about 69 us). What sets the pace is the walk: every step is a chain of
// two dependent loads (the node record, then the feature it names) and a
// compare, 100 trees deep per pixel. The first design (one walk at a time
// per thread, 16-byte records in global memory, `while (node >= 0)` loops
// whose lengths differ between the lanes of a warp, 16 f64 totals for any
// class count: 48 registers) took 1.8652 ms on an H100 80GB HBM3 at
// 700 W, 27 times its bound, with nothing in flight behind each load.
//
// What the design does about it:
//   * A pixel walks each tree from its root to the one leaf whose decisions
//     all agree: that leaf is exactly the one that fires in the dense form.
//   * Fixed-depth walks. The trees go in groups of kGroup (4) in tree order;
//     pack_forest (ops/kernels.py) pads every tree of a group to the
//     group's depth with padding records whose two children are the same
//     padding record (or the same leaf row), and fills a short last group
//     with trees whose one leaf has an all-zero distribution. Every lane
//     then takes the same number of steps, and a padding record's decision,
//     NaN included, cannot change the leaf it leads to.
//   * Four walks in flight per thread: the kGroup trees of a group step
//     together, so four independent load chains overlap.
//   * 8-byte records {feature | kids << 10, threshold bits}: the children
//     of a record are the adjacent slots kids (x <= thr) and kids + 1.
//     kids has 22 bits, so a packing holds fewer than 4 194 304 records
//     and leaf rows; pack_forest refuses more (the source's forest trained
//     on an ROI raster's 20 000 pixels, some 20 500 leaves at depth 24,
//     packs 380 220 records). A group's depth is only a loop bound: no
//     depth limit applies.
//     After the group's last step the slot is a row of the leaf table,
//     which holds each leaf's distribution in f64 (a padded leaf twice),
//     class major: lanes that reach different leaves read one class at a
//     time from neighbouring words, which spreads them over the banks
//     (measured 0.845 ms against 1.075 ms row major, same card). Its
//     classes are padded with zeros to the chunk, so the sums need no
//     bounds check.
//   * The records and the leaf table are staged in shared memory once per
//     block when they take at most 96 KB (FOREST_SHARED_BYTES in
//     ops/kernels.py; the bundled scale's forest takes 57 KB); larger
//     forests take the instance that reads them from global memory
//     through the L1. Blocks are persistent (as many as
//     fit on the card), each walking a stride of 512-pixel tiles, so the
//     forest is staged once per block, not once per tile.
//   * The block's x tile (F x 512 f32) is in shared memory; a thread reads
//     only its own column, whose banks never collide, so no barrier guards
//     it.
//   * Totals accumulate in f64 and round once to f32, then scale by
//     inv_trees in f32. With fractional leaf distributions an f32 sum
//     depends on its order: two classes whose exact totals share one f32
//     value can come out an ulp apart and flip the argmax. An f64 sum of a
//     few hundred f32 values in [0, 1] is exact, and the leaves are added
//     in tree order all the same (the four of a group one after another;
//     a filler tree adds +0.0, which changes no total), so every total is
//     the one the plain version rounds.
//   * The argmax keeps the LOWEST index on ties (strict >).
//   * The class totals are sized to the class count: kChunk is 4, 8 or 16
//     by the smallest that holds the classes. Past 16 classes (kWide) the
//     thread walks the trees once per chunk of 16, keeping a running best
//     across chunks; the chunks go in ascending class order and a later
//     chunk wins only with a strictly larger total, so ties still go to
//     the lowest index.
//
// Measured (tools/kernel_times.py, H100 80GB HBM3 at 700 W, L2 flushed):
// 0.837 ms at the main path's shape, against the first design's 1.883 in
// the same call; 2.671 ms (from 3.385) for a 6 127-leaf forest on the
// global-memory instance. The shared-memory wavefronts of the walk
// (record, feature, leaf classes) account for most of it: 12 times the
// bound (PERF.md section 6).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kGroup = 4;
constexpr int kFeatureBits = 10;
constexpr unsigned kFeatureMask = (1u << kFeatureBits) - 1u;

template <int kChunk, bool kWide, bool kShared>
__global__ void __launch_bounds__(kThreads)
forest_labels_kernel(const float* __restrict__ x,
                     const uint2* __restrict__ records, int n_records,
                     const double* __restrict__ leaf_table, int n_rows,
                     const int32_t* __restrict__ roots,
                     const int32_t* __restrict__ depths, int n_groups,
                     const int32_t* __restrict__ classes, float inv_trees,
                     int n_classes, int n_cols, int n_features, long long n,
                     long long tiles_per_image, long long n_tiles,
                     int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  uint2* s_rec = reinterpret_cast<uint2*>(smem);
  double* s_leaf = reinterpret_cast<double*>(smem);
  float* s_x = reinterpret_cast<float*>(smem);
  if constexpr (kShared) {
    s_leaf = reinterpret_cast<double*>(s_rec + n_records);
    const long long leaf_words = static_cast<long long>(n_rows) * n_cols;
    s_x = reinterpret_cast<float*>(s_leaf + leaf_words);
    for (int i = tid; i < n_records; i += kThreads) s_rec[i] = records[i];
    for (long long i = tid; i < leaf_words; i += kThreads) {
      s_leaf[i] = leaf_table[i];
    }
    __syncthreads();
  }
  float* my_x = s_x + tid;
  const int n_chunks = kWide ? (n_classes + kChunk - 1) / kChunk : 1;

  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long b = tile / tiles_per_image;
    const long long p = (tile - b * tiles_per_image) * kThreads + tid;
    if (p >= n) continue;                     // no barrier below
    const float* xp = x + b * n_features * n + p;
    for (int f = 0; f < n_features; ++f) {
      my_x[f * kThreads] = __ldg(&xp[f * n]);
    }

    int best = 0;
    float best_v = 0.0f;
    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      const int c0 = chunk * kChunk;
      double total[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) total[c] = 0.0;

      for (int g = 0; g < n_groups; ++g) {
        int node[kGroup];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          node[k] = __ldg(&roots[g * kGroup + k]);
        }
        const int depth = __ldg(&depths[g]);
        for (int s = 0; s < depth; ++s) {
#pragma unroll
          for (int k = 0; k < kGroup; ++k) {
            uint2 r;
            if constexpr (kShared) {
              r = s_rec[node[k]];
            } else {
              r = __ldg(&records[node[k]]);
            }
            const float v = my_x[(r.x & kFeatureMask) * kThreads];
            node[k] = static_cast<int>(r.x >> kFeatureBits)
                + (v <= __uint_as_float(r.y) ? 0 : 1);
          }
        }
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {      // tree order
#pragma unroll
          for (int c = 0; c < kChunk; ++c) {   // padded classes add zeros
            const long long at = static_cast<long long>(c0 + c) * n_rows
                + node[k];
            if constexpr (kShared) {
              total[c] += s_leaf[at];
            } else {
              total[c] += __ldg(&leaf_table[at]);
            }
          }
        }
      }

#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (c0 + c < n_classes) {
          const float v = static_cast<float>(total[c]) * inv_trees;
          if (c0 + c == 0 || v > best_v) {
            best_v = v;
            best = c0 + c;
          }
        }
      }
    }
    out[b * n + p] = __ldg(&classes[best]);
  }
}

using Kernel = void (*)(const float*, const uint2*, int, const double*, int,
                        const int32_t*, const int32_t*, int, const int32_t*,
                        float, int, int, int, long long, long long, long long,
                        int32_t*);

template <bool kShared>
Kernel pick(int n_classes) {
  if (n_classes <= 4) return forest_labels_kernel<4, false, kShared>;
  if (n_classes <= 8) return forest_labels_kernel<8, false, kShared>;
  if (n_classes <= 16) return forest_labels_kernel<16, false, kShared>;
  return forest_labels_kernel<16, true, kShared>;
}

}  // namespace

// x: (batch, n_features, n) f32; records: (n_records, 2) int32 {feature |
// kids << 10, threshold bits}; leaf_table: (n_cols, n_rows) f64, class
// major, its columns padded with zeros to a multiple of the chunk (4 up to
// 4 classes, 8 up to 8, else 16);
// roots: (n_groups * group,) int32, a record (or, in a group of depth 0, a
// row of the leaf table) per tree; depths: (n_groups,) int32; classes:
// (n_classes,) int32; out: (batch, n) int32. `group` must be the kernel's
// kGroup. `shared` nonzero stages the records and the leaf table in shared
// memory (the wrapper sets it when they take at most FOREST_SHARED_BYTES,
// ops/kernels.py). Returns the cudaError_t of the launch.
extern "C" int forest_labels_launch(const void* x, const void* records,
                                    int n_records, const void* leaf_table,
                                    int n_rows, const void* roots,
                                    const void* depths, int n_groups,
                                    int group, const void* classes,
                                    float inv_trees, int n_classes,
                                    int n_cols, int n_features, long long n,
                                    int batch, int shared,
                                    void* out, void* stream) {
  const int chunk = n_classes <= 4 ? 4 : n_classes <= 8 ? 8 : 16;
  if (group != kGroup || n_classes < 1 || n_groups < 1 || n_rows < 1
      || n_cols < n_classes || n_cols % chunk != 0
      || n_records < 0 || n_features < 1
      || n_features > static_cast<int>(kFeatureMask) + 1 || n <= 0
      || batch <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t x_bytes = sizeof(float) * n_features * kThreads;
  const size_t forest_bytes = sizeof(uint2) * n_records
      + sizeof(double) * static_cast<size_t>(n_rows) * n_cols;
  const Kernel kernel = shared ? pick<true>(n_classes)
                               : pick<false>(n_classes);
  const size_t smem = x_bytes + (shared ? forest_bytes : 0);
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess
      || (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device)) != cudaSuccess
      || (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &per_sm, kernel, kThreads, smem)) != cudaSuccess) {
    return static_cast<int>(e);
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles_per_image = (n + kThreads - 1) / kThreads;
  const long long n_tiles = tiles_per_image * batch;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const unsigned blocks = static_cast<unsigned>(
      n_tiles < resident ? n_tiles : resident);
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint2*>(records),
      n_records, static_cast<const double*>(leaf_table), n_rows,
      static_cast<const int32_t*>(roots),
      static_cast<const int32_t*>(depths), n_groups,
      static_cast<const int32_t*>(classes), inv_trees, n_classes, n_cols,
      n_features, n, tiles_per_image, n_tiles, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
