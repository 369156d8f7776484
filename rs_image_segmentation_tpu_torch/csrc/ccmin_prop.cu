// Two entry points over the 8- or 4-connected components of each (H, W)
// mask of an (M, H, W) stack; components never cross masks.
//   ccmin_prop_launch: every foreground pixel gets min(values over its
//     component); background gets -1.
//   cc_labels_launch: every foreground pixel gets its component's minimum
//     mask-relative linear index y * W + x; background gets -1.
//
// Replaces: rs_image_segmentation_tpu/ops/pallas_kernels.py
//   ccmin_prop_pallas (_ccmin_run, _cc_strip_kernel, _cc_sweep_kernel,
//   _cc_strip_converge, _coarse_seed) and
//   cc_pallas (_ccmin_run with jump=True, _cc_strip_kernel,
//   _cc_strip_converge).
//
// What bounds it on an H100: bytes, at best. The function reads the mask
// (1 B) and the values (4 B) and writes the result (4 B) per pixel: at the
// rule path's first stage (24 x 600 x 600) that is 77.8 MB, about 23 us at
// 3.35 TB/s. The TPU kernel iterated a min-propagation to a fixed point,
// strip by strip, with gated halo passes; its cost grew with the number
// of turns a component makes. Here the work is union-find, whose cost does
// not depend on the geometry beyond the depth of the trees it builds.
// cc_labels reads the mask (1 B) and writes the labels (4 B) per pixel:
// 1.8 MB for one 600 x 600 mask, 0.54 us at 3.35 TB/s, so there its three
// launches' latency bounds it; 180 MB for one 6000 x 6000 mask, about
// 54 us, where bytes bound it.
//
// What the design does about it:
//   * Union-find with the root at the minimum linear index: every link
//     goes from a root to a smaller index (atomicMin), so a root is the
//     smallest index of its tree. The result is exact whatever the order
//     of the atomics, since min does not depend on order.
//   * Pass 1 (one block per 32 x 32 tile): union-find in shared memory
//     over the tile's own pixels, then a warp-aggregated shared atomicMin
//     of the values into each local root. It writes each pixel's parent
//     (the global index of its local root, -1 at background) and, at
//     local roots, the local minimum (INT_MAX elsewhere). Tiles bound the
//     depth of the global trees by the number of tiles a component spans.
//   * Pass 2 (96 threads per tile): unites the pairs that cross a tile
//     border (top row, left and right columns) in global memory.
//   * Pass 3 (one thread per pixel): each pixel finds its root and stores
//     it (path compression); each local root folds its minimum into its
//     global root with one atomicMin.
//   * Pass 4 (one thread per pixel): gathers the root's minimum.
//   The output buffer holds the parents until pass 4 overwrites them in
//   place; `minv` is one int32 scratch plane per pixel, from the wrapper.
//   cc_labels runs passes 1 and 2 without the values (parents only), then
//   one labelling pass: each pixel finds its root, stores it in the
//   parents (path compression) and writes root - mask base to the labels,
//   -1 at background. The roots are stack-global indices, hence the base.
//   Union-find always converges, so there is no round bound to cut it.
//   Mask-relative neighbours are checked against the mask's own H and W,
//   so masks stacked in M never touch.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;                   // tile edge = warp width
constexpr int kTileThreads = kTile * kTile; // pass 1: one thread per pixel
constexpr int kFlatThreads = 256;           // passes 3 and 4
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int find_root(const volatile int* parent, int x) {
  int p = parent[x];
  while (p != x) {
    x = p;
    p = parent[x];
  }
  return x;
}

// Joins the trees of a and b: the larger root is linked under the smaller
// one. If that root was linked elsewhere meanwhile, atomicMin returns its
// new parent and the loop joins that one instead, so no link is lost.
__device__ __forceinline__ void unite(int* parent, int a, int b) {
  const volatile int* vp = parent;
  while (true) {
    a = find_root(vp, a);
    b = find_root(vp, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(&parent[b], a);
    if (old == b) return;
    b = old;
  }
}

// kMin: also fold the values into each local root (ccmin_prop); without
// it the pass writes the parents only (cc_labels), and values and minv
// are not read.
template <int kConn, bool kMin>
__global__ void __launch_bounds__(kTileThreads)
ccmin_tile(const uint8_t* __restrict__ mask, const int* __restrict__ values,
           int* __restrict__ parent, int* __restrict__ minv, int h, int w) {
  __shared__ int s_lab[kTileThreads];
  __shared__ int s_min[kMin ? kTileThreads : 1];
  __shared__ uint8_t s_fg[kTileThreads];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int t = ty * kTile + tx;
  const int x = blockIdx.x * kTile + tx;
  const int y = blockIdx.y * kTile + ty;
  const bool in = x < w && y < h;
  const int g = blockIdx.z * h * w + y * w + x;   // < 2^31 (host check)
  const bool fg = in && mask[g] != 0;
  s_fg[t] = fg;
  s_lab[t] = t;
  if constexpr (kMin) s_min[t] = INT_MAX;
  __syncthreads();

  // Each 8- (or 4-) adjacent pair of the tile ends up joined, with fewer
  // atomics than one per pair: a pixel whose left neighbour is foreground
  // reaches the row above through it (see tests/test_torch_kernels.py for
  // the numpy rendering of this rule).
  if (fg) {
    const bool l = tx > 0 && s_fg[t - 1];
    const bool u = ty > 0 && s_fg[t - kTile];
    const bool ul = tx > 0 && ty > 0 && s_fg[t - kTile - 1];
    if (l) unite(s_lab, t, t - 1);
    if (kConn == 8) {
      const bool ur = tx < kTile - 1 && ty > 0 && s_fg[t - kTile + 1];
      if (!l) {
        if (u) {
          unite(s_lab, t, t - kTile);
        } else {
          if (ul) unite(s_lab, t, t - kTile - 1);
          if (ur) unite(s_lab, t, t - kTile + 1);
        }
      } else if (!u && ur) {
        unite(s_lab, t, t - kTile + 1);
      }
    } else if (u && !(l && ul)) {
      unite(s_lab, t, t - kTile);
    }
  }
  __syncthreads();

  const int r = fg ? find_root(s_lab, t) : -1;
  if constexpr (kMin) {
    const int v = fg ? values[g] : INT_MAX;
    // a warp is one tile row: lanes of one run share their root
    const unsigned peers = __match_any_sync(kFull, r);
    const int vmin = __reduce_min_sync(peers, v);
    if (fg && tx == __ffs(peers) - 1) atomicMin(&s_min[r], vmin);
    __syncthreads();
  }

  if (in) {
    if (fg) {
      const int rx = blockIdx.x * kTile + r % kTile;
      const int ry = blockIdx.y * kTile + r / kTile;
      parent[g] = blockIdx.z * h * w + ry * w + rx;
    } else {
      parent[g] = -1;
    }
    if constexpr (kMin) minv[g] = (fg && r == t) ? s_min[t] : INT_MAX;
  }
}

// Threads 0..31: the tile's top row; 32..63: its left column below the
// top row; 64..95: its right column below the top row. Each joins its
// pixel with the earlier neighbours (left, up-left, up, up-right; left and
// up for 4-connectivity) that lie in another tile.
template <int kConn>
__global__ void __launch_bounds__(3 * kTile)
ccmin_borders(const uint8_t* __restrict__ mask, int* parent, int h, int w) {
  const int k = threadIdx.x;
  int tx, ty;
  if (k < kTile) {
    tx = k;
    ty = 0;
  } else if (k < 2 * kTile) {
    tx = 0;
    ty = k - kTile + 1;
  } else {
    tx = kTile - 1;
    ty = k - 2 * kTile + 1;
  }
  if (ty >= kTile) return;
  const int x = blockIdx.x * kTile + tx;
  const int y = blockIdx.y * kTile + ty;
  if (x >= w || y >= h) return;
  const int base = blockIdx.z * h * w;
  const int g = base + y * w + x;
  if (mask[g] == 0) return;
  if (tx == 0 && x > 0 && mask[g - 1]) unite(parent, g, g - 1);
  if (ty == 0 && y > 0 && mask[g - w]) unite(parent, g, g - w);
  if (kConn == 8 && y > 0) {
    if ((tx == 0 || ty == 0) && x > 0 && mask[g - w - 1]) {
      unite(parent, g, g - w - 1);
    }
    if ((tx == kTile - 1 || ty == 0) && x + 1 < w && mask[g - w + 1]) {
      unite(parent, g, g - w + 1);
    }
  }
}

__global__ void __launch_bounds__(kFlatThreads)
ccmin_compress(int* parent, int* minv, int n) {
  const long long i = static_cast<long long>(blockIdx.x) * kFlatThreads
      + threadIdx.x;
  if (i >= n) return;
  const int g = static_cast<int>(i);
  if (parent[g] < 0) return;
  const int r = find_root(parent, g);
  parent[g] = r;
  const int m = minv[g];     // a local root's minimum, INT_MAX elsewhere
  if (r != g && m != INT_MAX) atomicMin(&minv[r], m);
}

__global__ void __launch_bounds__(kFlatThreads)
ccmin_gather(int* out, const int* __restrict__ minv, int n) {
  const long long i = static_cast<long long>(blockIdx.x) * kFlatThreads
      + threadIdx.x;
  if (i >= n) return;
  const int r = out[i];
  if (r >= 0) out[i] = minv[r];
}

// Labels from the parents: root - mask base at foreground, -1 at
// background. `parent` and `out` may be one buffer when the stack holds
// one mask (base 0): both stores then write the root.
__global__ void __launch_bounds__(kFlatThreads)
cc_label(int* parent, int* out, int n, int hw) {
  const long long i = static_cast<long long>(blockIdx.x) * kFlatThreads
      + threadIdx.x;
  if (i >= n) return;
  const int g = static_cast<int>(i);
  if (parent[g] < 0) {
    out[g] = -1;
    return;
  }
  const int r = find_root(parent, g);
  parent[g] = r;
  out[g] = r - (g / hw) * hw;
}

template <int kConn>
void launch(const uint8_t* mask, const int* values, int* out, int* minv,
            int m, int h, int w, cudaStream_t s) {
  const dim3 tiles((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, m);
  ccmin_tile<kConn, true><<<tiles, dim3(kTile, kTile), 0, s>>>(
      mask, values, out, minv, h, w);
  ccmin_borders<kConn><<<tiles, 3 * kTile, 0, s>>>(mask, out, h, w);
  const int n = m * h * w;
  const int blocks = (n + kFlatThreads - 1) / kFlatThreads;
  ccmin_compress<<<blocks, kFlatThreads, 0, s>>>(out, minv, n);
  ccmin_gather<<<blocks, kFlatThreads, 0, s>>>(out, minv, n);
}

template <int kConn>
void launch_labels(const uint8_t* mask, int* out, int* parent, int m, int h,
                   int w, cudaStream_t s) {
  const dim3 tiles((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, m);
  ccmin_tile<kConn, false><<<tiles, dim3(kTile, kTile), 0, s>>>(
      mask, nullptr, parent, nullptr, h, w);
  ccmin_borders<kConn><<<tiles, 3 * kTile, 0, s>>>(mask, parent, h, w);
  const int n = m * h * w;
  const int blocks = (n + kFlatThreads - 1) / kFlatThreads;
  cc_label<<<blocks, kFlatThreads, 0, s>>>(parent, out, n, h * w);
}

bool bad_shape(int m, int h, int w, int connectivity) {
  return m <= 0 || h <= 0 || w <= 0 || m > 65535
      || static_cast<long long>(m) * h * w > INT_MAX
      || (connectivity != 8 && connectivity != 4);
}

}  // namespace

// mask: (m, h, w) uint8 (nonzero = foreground); values: (m, h, w) int32;
// out: (m, h, w) int32; minv: (m, h, w) int32 scratch. m * h * w must fit
// in int32 and m in 65535. Returns the cudaError_t of the launches.
extern "C" int ccmin_prop_launch(const void* mask, const void* values,
                                 void* out, void* minv, int m, int h, int w,
                                 int connectivity, void* stream) {
  if (bad_shape(m, h, w, connectivity)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto mk = static_cast<const uint8_t*>(mask);
  auto v = static_cast<const int*>(values);
  auto o = static_cast<int*>(out);
  auto mv = static_cast<int*>(minv);
  if (connectivity == 8) {
    launch<8>(mk, v, o, mv, m, h, w, s);
  } else {
    launch<4>(mk, v, o, mv, m, h, w, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// mask: (m, h, w) uint8 (nonzero = foreground); out: (m, h, w) int32
// labels; parent: (m, h, w) int32 scratch, which may be `out` itself when
// m == 1. m * h * w must fit in int32 and m in 65535. Returns the
// cudaError_t of the launches.
extern "C" int cc_labels_launch(const void* mask, void* out, void* parent,
                                int m, int h, int w, int connectivity,
                                void* stream) {
  if (bad_shape(m, h, w, connectivity) || (parent == out && m != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto mk = static_cast<const uint8_t*>(mask);
  auto o = static_cast<int*>(out);
  auto p = static_cast<int*>(parent);
  if (connectivity == 8) {
    launch_labels<8>(mk, o, p, m, h, w, s);
  } else {
    launch_labels<4>(mk, o, p, m, h, w, s);
  }
  return static_cast<int>(cudaGetLastError());
}
