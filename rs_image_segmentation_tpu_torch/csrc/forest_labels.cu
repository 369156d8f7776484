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
// What bounds it on an H100: at the main-path shape the least time is
// set by bytes (19 f32 read and one int32 written per pixel, about 69 us);
// the decisions the data needs (one per level of each tree walked) would
// take less at the f32 rate. In practice each tree walk is a chain of
// dependent loads (node, then feature, then the next node), so latency
// and warp divergence set the pace.
//
// What the design does about it:
//   * The wrapper checks that the GemmForest's paths form binary trees and
//     packs them into child links (ops/kernels.py pack_forest). A pixel
//     walks each tree from its root to the one leaf whose decisions all
//     agree: that leaf is exactly the one that fires in the dense form, and
//     a walk takes depth-many decisions where testing every leaf path
//     takes about two per leaf (measured 12.8 ms for the leaf-path form at
//     the main-path shape, PERF.md).
//   * A node is one 16-byte record {feature, threshold bits, left, right},
//     one __ldg per step; a child >= 0 is a node, ~child is a leaf.
//   * One thread per pixel. The block's x tile (F x 256 f32) is staged in
//     shared memory with coalesced loads; a thread only reads its own
//     column, whose banks never collide, so no barrier is needed.
//   * The TPU workarounds are gone: no 3-term bf16 split of x (the f32
//     feature is read exactly), no int8 vote matmul, no VMEM budget, no
//     tree plan.
//   * Totals accumulate in f64 and round once to f32, then scale by
//     inv_trees in f32. With fractional leaf distributions an f32 sum
//     depends on its order: two classes whose exact totals share one f32
//     value can come out an ulp apart and flip the argmax (measured: 1 of
//     4096 pixels against the JAX package's XLA sum). An f64 sum of a few
//     hundred f32 values in [0, 1] is exact, so every order rounds to the
//     same f32 total. Pure leaves (0/1 distributions) are exact either way.
//   * The argmax keeps the LOWEST index on ties (strict >).
//   * Any class count: a thread keeps kChunk f64 totals in registers and,
//     past kChunk classes (the kWide instance), walks the trees once per
//     chunk of kChunk classes, keeping a running best across chunks. The
//     chunks go in ascending class order and a later chunk wins only with
//     a strictly larger total, so ties still go to the lowest index; each
//     class's sum keeps its tree order, so the labels do not depend on the
//     chunking. A forest of up to kChunk
//     classes takes the instance with one walk, as before the chunks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;

// kWide = false: at most kChunk classes, one walk of the trees (the
// main path's forests); kWide = true: one walk per chunk of kChunk classes.
template <bool kWide>
__global__ void __launch_bounds__(kThreads)
forest_labels_kernel(const float* __restrict__ x,
                     const int4* __restrict__ nodes,
                     const int32_t* __restrict__ roots, int n_trees,
                     const float* __restrict__ leaf_dist,
                     const int32_t* __restrict__ classes, float inv_trees,
                     int n_classes, int n_features, long long n,
                     int32_t* __restrict__ out) {
  extern __shared__ float s_x[];               // [n_features][kThreads]
  const int tid = threadIdx.x;
  const long long p = (long long)blockIdx.x * kThreads + tid;
  const long long b = blockIdx.y;
  if (p >= n) return;                          // s_x is per-thread: no barrier
  const float* xp = x + b * n_features * n + p;
  for (int f = 0; f < n_features; ++f) s_x[f * kThreads + tid] = xp[f * n];

  int best = 0;
  float best_v = 0.0f;
  const int n_chunks = kWide ? (n_classes + kChunk - 1) / kChunk : 1;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int c0 = chunk * kChunk;
    double total[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) total[c] = 0.0;

    for (int t = 0; t < n_trees; ++t) {
      int node = __ldg(&roots[t]);
      while (node >= 0) {
        const int4 nd = __ldg(&nodes[node]);
        node = s_x[nd.x * kThreads + tid] <= __int_as_float(nd.y) ? nd.z
                                                                  : nd.w;
      }
      const float* d = leaf_dist + (long long)(~node) * n_classes + c0;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (c0 + c < n_classes) total[c] += static_cast<double>(__ldg(&d[c]));
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

}  // namespace

// x: (batch, n_features, n) f32; nodes: (M, 4) int32 records {feature,
// threshold bits, left, right}; roots: (n_trees,) int32 (a root < 0 is a
// one-leaf tree, ~root its leaf); leaf_dist: (n_leaves, n_classes) f32;
// classes: (n_classes,) int32; out: (batch, n) int32. Returns the
// cudaError_t of the launch.
extern "C" int forest_labels_launch(const void* x, const void* nodes,
                                    const void* roots, int n_trees,
                                    const void* leaf_dist,
                                    const void* classes, float inv_trees,
                                    int n_classes, int n_features,
                                    long long n, int batch, void* out,
                                    void* stream) {
  if (n_classes < 1 || n_trees < 1
      || n_features < 1 || n <= 0 || batch <= 0 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * n_features * kThreads;
  auto kernel = n_classes <= kChunk ? forest_labels_kernel<false>
                                    : forest_labels_kernel<true>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int4*>(nodes),
      static_cast<const int32_t*>(roots), n_trees,
      static_cast<const float*>(leaf_dist),
      static_cast<const int32_t*>(classes), inv_trees, n_classes,
      n_features, n, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
