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
// What bounds it on an H100: bytes, at best. ccmin_prop reads the mask
// (1 B) and the values (4 B) and writes the result (4 B) per pixel: at the
// rule path's first stage (24 x 600 x 600) that is 77.8 MB, about 23 us at
// 3.35 TB/s. cc_labels reads the mask and writes the labels: 1.8 MB for one
// 600 x 600 mask (0.54 us, so the launches' latency bounds it there) and
// 180 MB for one 6000 x 6000 mask (about 54 us). The first design (a
// union-find node per pixel, 32 x 32-thread tile blocks, border unions and
// a per-pixel pass that chased uncompressed chains through global memory)
// took 0.4329 ms at 24 x 600 x 600 on an H100 80GB HBM3 at 700 W, 19 times
// its bound.
//
// What the design does about it (union-find labelling on the GPU as in
// Komura 2015, Playne & Hawick 2018, and the block-based method of
// Allegretti, Bolelli & Grana 2020):
//   * 8-connectivity takes one union-find node per 2 x 2 pixel block: the
//     foreground pixels of a block are always 8-connected, so a quarter of
//     the nodes, unions and finds remain. Two blocks join when a
//     foreground pixel of one touches one of the other (left: the left
//     column against the neighbour's right column; up: the top row against
//     the neighbour's bottom row; the diagonals: the facing corners).
//     4-connectivity keeps one node per pixel.
//   * Each node carries the minimum of its foreground pixels' values; for
//     cc_labels the value is the pixel's mask-relative index (a block's
//     minimum is its first foreground pixel in raster order), so both entry
//     points are one min-fold and cc_labels needs no value plane.
//   * Pass 1, cc_tile (512 threads, 16 warps, for a 32 x 32-node tile; a warp
//     takes one tile row at a time: 0.0550 ms at the rule path's first stage
//     against 0.0689 ms with 256 threads and 0.0569 ms with 1024, on one
//     card): union-find in shared memory. A ballot finds the runs of
//     left-joined nodes in a row, and each node links straight to its run's
//     first node, so a row costs no atomics; then each node unites with the
//     row above, leaving out the links its run already makes (up_links), so a
//     solid run makes one link, not three per node. A segmented warp scan
//     takes each run's minimum, and its last lane folds it into the local root
//     with one shared atomicMin. The pass writes each node's parent (the
//     global index of its local root, -1 at background) and, at local roots,
//     the local minimum (INT_MAX elsewhere). Finds halve paths.
//   * Pass 2, cc_borders (one thread per tile-border node, over a flat
//     grid): unites the node pairs that cross a tile border in global
//     memory, leaving out those that a run or the pair one row up joins
//     already (in a solid area, one link per tile edge).
//   * Pass 3, cc_roots (one thread per node): each local root finds its
//     root, stores it, and folds its minimum into the root with one
//     atomicMin; other nodes return after one load.
//   * Pass 4, cc_gather (one thread per node): each of the node's pixels
//     gets the root's minimum, -1 at background.
//   Union-find always converges, so there is no round bound to cut it.
//   Node neighbours are checked against the mask's own node grid, so masks
//   stacked in M never touch.
//
// Why the result is exact whatever the order of the atomics:
//   * Every link goes from a node to a smaller index: unite links the
//     larger of two roots under the smaller with atomicMin, and the finds
//     of passes 2 and 3 halve paths (parent[x] = parent[parent[x]]), which
//     also points to a smaller index. So the parents never form a cycle and
//     a root is the smallest index of its tree.
//   * No union is lost. atomicMin on a root b that another thread has
//     linked meanwhile returns b's new parent; unite then joins that one
//     instead, so a, b and b's new parent end up in one set. A halving
//     store replaces the link x -> p by x -> parent[p], an ancestor of p,
//     so x stays in p's set; when it overwrites a link that a concurrent
//     unite made with atomicMin, that unite saw the old parent in the
//     return value and joins it with its own node, so both ends stay in
//     one set. Sets only merge, and every pair a pass unites ends in one
//     set.
//   * A pair that passes 1 and 2 leave out (up_links, and the border
//     rules) joins nodes that pairs of an earlier row, or of the same row
//     further left, already join; by induction over rows, then columns,
//     every adjacent pair ends in one set, so after pass 2 the sets are
//     exactly the components.
//   * Pass 3 runs after every union; its stores point to ancestors, and
//     pass 4 finds the root again (read-only) rather than trusting one
//     stored parent. The minimum does not depend on the order of the
//     atomicMins.
//
// Measured (tools/kernel_times.py, H100 80GB HBM3 at 700 W, L2 flushed):
// ccmin_prop 0.110 ms at 24 x 600 x 600 (tile 0.057, borders 0.015, roots
// 0.009, gather 0.022) against the first design's 0.434 in the same call;
// cc_labels 0.029 ms per 600 x 600 mask (from 0.046) and 0.349 ms per
// 6000 x 6000 mask (from 1.529) (PERF.md section 6).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileN = 32;                       // nodes per tile edge
constexpr int kTileNodes = kTileN * kTileN;
constexpr int kTileThreads = 512;                // 16 warps, a tile row each
constexpr int kWarps = kTileThreads / 32;
constexpr int kRowsPerWarp = kTileN / kWarps;
constexpr int kBorderSlots = 3 * kTileN;         // 32 top, 32 left, 31 right
constexpr int kFlatThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Grid {        // a stack of masks and its node grid
  int h, w;          // pixels per mask
  int nh, nw;        // nodes per mask (blocks of kB x kB pixels)
  int tiles_y, tiles_x;
  int m;
};

// Bits of node (nx, ny): for kB = 2, bit 0 (y0, x0), bit 1 (y0, x0 + 1),
// bit 2 (y0 + 1, x0), bit 3 (y0 + 1, x0 + 1), pixels past the mask's edge
// 0; for kB = 1, bit 0 the pixel.
template <int kB>
__device__ __forceinline__ unsigned node_bits(const uint8_t* __restrict__ mk,
                                              const Grid& g, int nx, int ny) {
  const int y0 = ny * kB, x0 = nx * kB;
  const uint8_t* row = mk + static_cast<long long>(y0) * g.w + x0;
  unsigned bits = row[0] != 0;
  if constexpr (kB == 2) {
    const bool right = x0 + 1 < g.w, down = y0 + 1 < g.h;
    if (right && row[1]) bits |= 2u;
    if (down && row[g.w]) bits |= 4u;
    if (right && down && row[g.w + 1]) bits |= 8u;
  }
  return bits;
}

// The minimum over the node's foreground pixels of values (kIndex: of
// their mask-relative indices).
template <int kB, bool kIndex>
__device__ __forceinline__ int node_min(const int* __restrict__ vals,
                                        const Grid& g, int nx, int ny,
                                        unsigned bits) {
  const int y0 = ny * kB, x0 = nx * kB;
  if constexpr (kIndex) {
    const int i = __ffs(bits) - 1;               // first in raster order
    return (y0 + (i >> 1)) * g.w + x0 + (i & 1);
  } else {
    const int* row = vals + static_cast<long long>(y0) * g.w + x0;
    int v = INT_MAX;
    if (bits & 1u) v = row[0];
    if constexpr (kB == 2) {
      if (bits & 2u) v = min(v, row[1]);
      if (bits & 4u) v = min(v, row[g.w]);
      if (bits & 8u) v = min(v, row[g.w + 1]);
    }
    return v;
  }
}

// Whether a node with `bits` joins its neighbour with `nb` on the left,
// above, above-left or above-right.
template <int kB>
__device__ __forceinline__ bool joins_left(unsigned bits, unsigned nb) {
  return kB == 1 ? (bits & nb) != 0 : (bits & 5u) && (nb & 10u);
}
template <int kB>
__device__ __forceinline__ bool joins_up(unsigned bits, unsigned nb) {
  return kB == 1 ? (bits & nb) != 0 : (bits & 3u) && (nb & 12u);
}
__device__ __forceinline__ bool joins_up_left(unsigned bits, unsigned nb) {
  return (bits & 1u) && (nb & 8u);
}
__device__ __forceinline__ bool joins_up_right(unsigned bits, unsigned nb) {
  return (bits & 2u) && (nb & 4u);
}

// Which links to the row above a node makes itself: bit 0 up-left, bit 1
// up, bit 2 up-right. `b` is the node, `lb` its left neighbour, `left`
// whether the two are one run (left-joined), and ul, u, ur the row above
// (0 past an edge). A link is left out when its two nodes end up joined
// anyway: through the left neighbour, whose own links are made (or left
// out) by the same rule, or through a link this node makes to a node that
// is one run with the other in the row above. The joins a rule leans on
// are all of an earlier row, or of the same row further left, so every
// adjacent pair still ends in one set. In a solid area a run makes one
// link upwards instead of three per node.
template <int kB>
__device__ __forceinline__ unsigned up_links(unsigned b, bool left,
                                             unsigned lb, unsigned ul,
                                             unsigned u, unsigned ur) {
  if constexpr (kB == 1) {
    return (b && u && !(left && ul)) ? 2u : 0u;
  } else {
    const bool j_ul = joins_up_left(b, ul);
    const bool j_u = joins_up<2>(b, u);
    const bool via_ul = left && joins_up<2>(lb, ul);    // t ~ X-1 by t-1
    const bool via_u = left && joins_up_right(lb, u);   // t ~ X by t-1
    const bool to_ul = j_ul || via_ul;
    const bool ul_run = joins_left<2>(u, ul);           // X-1 ~ X
    const bool to_u = j_u || via_u || (to_ul && ul_run);
    return (j_ul && !via_ul ? 1u : 0u)
        | (j_u && !via_u && !(to_ul && ul_run) ? 2u : 0u)
        | (joins_up_right(b, ur) && !(to_u && joins_left<2>(ur, u)) ? 4u
                                                                    : 0u);
  }
}

// Finds x's root, halving the path on the way: each visited node is
// pointed at its grandparent (an ancestor, a smaller index).
__device__ __forceinline__ int find_halving(volatile int* parent, int x) {
  while (true) {
    const int p = parent[x];
    if (p == x) return x;
    const int gp = parent[p];
    if (gp == p) return p;
    parent[x] = gp;
    x = gp;
  }
}

// Joins the trees of a and b: the larger root is linked under the smaller
// one. If that root was linked elsewhere meanwhile, atomicMin returns its
// new parent and the loop joins that one instead, so no link is lost.
__device__ __forceinline__ void unite(int* parent, int a, int b) {
  volatile int* vp = parent;
  while (true) {
    a = find_halving(vp, a);
    b = find_halving(vp, b);
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

template <int kB, bool kIndex>
__global__ void __launch_bounds__(kTileThreads)
cc_tile(const uint8_t* __restrict__ mask, const int* __restrict__ values,
        int* __restrict__ parent, int* __restrict__ minv, Grid g) {
  __shared__ int s_par[kTileNodes];
  __shared__ int s_min[kTileNodes];
  __shared__ uint8_t s_bits[kTileNodes];
  const int lane = threadIdx.x % 32;           // the node's column in the tile
  const int warp = threadIdx.x / 32;
  const int nx = blockIdx.x * kTileN + lane;
  const int z = blockIdx.z;
  const long long pix_base = static_cast<long long>(z) * g.h * g.w;
  unsigned bits[kRowsPerWarp];
  int v[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {      // rows warp, warp + 16
    const int ty = warp + i * kWarps;
    const int ny = blockIdx.y * kTileN + ty;
    const bool in = nx < g.nw && ny < g.nh;
    bits[i] = in ? node_bits<kB>(mask + pix_base, g, nx, ny) : 0u;
    v[i] = bits[i] ? node_min<kB, kIndex>(values + (kIndex ? 0 : pix_base),
                                          g, nx, ny, bits[i])
                   : INT_MAX;
    s_bits[ty * kTileN + lane] = static_cast<uint8_t>(bits[i]);
    s_min[ty * kTileN + lane] = INT_MAX;
  }
  __syncthreads();

  // a warp is one tile row: each node links straight to the first node of
  // its run of left-joined nodes (the highest lane at or below it whose
  // node does not join its left neighbour)
  bool left[kRowsPerWarp], last[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int t = (warp + i * kWarps) * kTileN + lane;
    left[i] = lane > 0 && joins_left<kB>(bits[i], s_bits[t - 1]);
    const unsigned joined = __ballot_sync(kFull, left[i]);
    const int start = 31 - __clz(~joined & (kFull >> (31 - lane)));
    s_par[t] = t - lane + start;
    // the run's minimum, gathered at its last lane (a segmented scan)
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int o = __shfl_up_sync(kFull, v[i], d);
      if (lane - d >= start) v[i] = min(v[i], o);
    }
    last[i] = lane == 31 || !((joined >> (lane + 1)) & 1u);
  }
  __syncthreads();

  // the tile's other pairs: each node and its neighbours in the row above
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int ty = warp + i * kWarps;
    const int t = ty * kTileN + lane;
    if (!bits[i] || ty == 0) continue;
    const int up = t - kTileN;
    const unsigned links = up_links<kB>(
        bits[i], left[i], lane > 0 ? s_bits[t - 1] : 0u,
        lane > 0 ? s_bits[up - 1] : 0u, s_bits[up],
        lane < kTileN - 1 ? s_bits[up + 1] : 0u);
    if (links & 1u) unite(s_par, t, up - 1);
    if (links & 2u) unite(s_par, t, up);
    if (links & 4u) unite(s_par, t, up + 1);
  }
  __syncthreads();

  int r[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int t = (warp + i * kWarps) * kTileN + lane;
    r[i] = bits[i] ? find_halving(s_par, t) : -1;
    if (bits[i] && last[i]) atomicMin(&s_min[r[i]], v[i]);   // one per run
  }
  __syncthreads();

  const int node_base = z * g.nh * g.nw;
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int ty = warp + i * kWarps;
    const int t = ty * kTileN + lane;
    const int ny = blockIdx.y * kTileN + ty;
    if (nx >= g.nw || ny >= g.nh) continue;
    const int gi = node_base + ny * g.nw + nx;
    if (bits[i]) {
      const int rx = blockIdx.x * kTileN + r[i] % kTileN;
      const int ry = blockIdx.y * kTileN + r[i] / kTileN;
      parent[gi] = node_base + ry * g.nw + rx;
    } else {
      parent[gi] = -1;
    }
    minv[gi] = (bits[i] && r[i] == t) ? s_min[t] : INT_MAX;
  }
}

// One thread per border slot of each tile: slots 0..31 the tile's top row
// (its neighbours above: up-left, up, up-right), 32..63 its left column
// (left, and up-left below the top row), 64..94 its right column below the
// top row (up-right). Each joins its node with the neighbours that lie in
// another tile.
template <int kB>
__global__ void __launch_bounds__(kFlatThreads)
cc_borders(const uint8_t* __restrict__ mask, int* parent, Grid g,
           long long n_slots) {
  const long long i = static_cast<long long>(blockIdx.x) * kFlatThreads
      + threadIdx.x;
  if (i >= n_slots) return;
  const int k = static_cast<int>(i % kBorderSlots);
  long long tile = i / kBorderSlots;
  const int bx = static_cast<int>(tile % g.tiles_x);
  tile /= g.tiles_x;
  const int by = static_cast<int>(tile % g.tiles_y);
  const int z = static_cast<int>(tile / g.tiles_y);
  int tx, ty;
  if (k < kTileN) {
    tx = k;
    ty = 0;
  } else if (k < 2 * kTileN) {
    tx = 0;
    ty = k - kTileN;
  } else {
    if (kB == 1) return;                     // 4-connected: no diagonals
    tx = kTileN - 1;
    ty = k - 2 * kTileN + 1;
    if (ty >= kTileN) return;
  }
  const int nx = bx * kTileN + tx, ny = by * kTileN + ty;
  if (nx >= g.nw || ny >= g.nh) return;
  const uint8_t* mk = mask + static_cast<long long>(z) * g.h * g.w;
  const unsigned bits = node_bits<kB>(mk, g, nx, ny);
  if (!bits) return;
  const int gi = z * g.nh * g.nw + ny * g.nw + nx;
  const int up = gi - g.nw;
  auto at = [&](int x, int y) -> unsigned {   // 0 past the node grid
    return x >= 0 && x < g.nw && y >= 0 ? node_bits<kB>(mk, g, x, y) : 0u;
  };
  if (k < kTileN) {                          // top row
    if (ny == 0) return;
    const unsigned lb = tx > 0 ? at(nx - 1, ny) : 0u;   // in this tile
    const unsigned links = up_links<kB>(
        bits, tx > 0 && joins_left<kB>(bits, lb), lb,
        kB == 2 ? at(nx - 1, ny - 1) : 0u, at(nx, ny - 1),
        kB == 2 ? at(nx + 1, ny - 1) : 0u);
    if (links & 1u) unite(parent, gi, up - 1);
    if (links & 2u) unite(parent, gi, up);
    if (links & 4u) unite(parent, gi, up + 1);
    return;
  }
  // below the top row the node above is in this tile, joined to this one
  // when they touch; a pair is left out when that join and the pair one
  // row up (made or left out by the same rule) already join its nodes
  const bool up_joined = ty > 0 && joins_up<kB>(bits, at(nx, ny - 1));
  if (k < 2 * kTileN) {                      // left column
    if (nx == 0) return;
    const unsigned lb = at(nx - 1, ny), la = at(nx - 1, ny - 1);
    const bool row_above = up_joined
        && joins_left<kB>(at(nx, ny - 1), la);
    if (joins_left<kB>(bits, lb) && !(row_above && joins_up<kB>(lb, la))) {
      unite(parent, gi, gi - 1);
    }
    if constexpr (kB == 2) {
      if (ty > 0 && joins_up_left(bits, la) && !row_above) {
        unite(parent, gi, up - 1);
      }
    }
  } else if (joins_up_right(bits, at(nx + 1, ny - 1))   // right column
             && !(up_joined
                  && joins_left<kB>(at(nx + 1, ny - 1), at(nx, ny - 1)))) {
    unite(parent, gi, up + 1);
  }
}

__global__ void __launch_bounds__(kFlatThreads)
cc_roots(int* parent, int* minv, int n_nodes) {
  const long long i = static_cast<long long>(blockIdx.x) * kFlatThreads
      + threadIdx.x;
  if (i >= n_nodes) return;
  const int gi = static_cast<int>(i);
  const int m = minv[gi];    // a local root's minimum, INT_MAX elsewhere
  if (m == INT_MAX) return;  // (an INT_MAX minimum folds nothing either)
  volatile int* vp = parent;
  const int p = vp[gi];
  const int r = find_halving(vp, gi);
  if (r != p) vp[gi] = r;
  if (r != gi) atomicMin(&minv[r], m);
}

template <int kB>
__global__ void __launch_bounds__(kFlatThreads)
cc_gather(const uint8_t* __restrict__ mask, const int* __restrict__ parent,
          const int* __restrict__ minv, int* __restrict__ out, Grid g) {
  const long long i = static_cast<long long>(blockIdx.x) * kFlatThreads
      + threadIdx.x;
  const int per_mask = g.nh * g.nw;
  if (i >= static_cast<long long>(g.m) * per_mask) return;
  const int gi = static_cast<int>(i);
  const int z = gi / per_mask;
  const int ny = (gi - z * per_mask) / g.nw;
  const int nx = gi - z * per_mask - ny * g.nw;
  int v = -1;
  int r = parent[gi];
  if (r >= 0) {
    for (int p = parent[r]; p != r; p = parent[r]) r = p;
    v = minv[r];
  }
  const long long base = static_cast<long long>(z) * g.h * g.w
      + static_cast<long long>(ny) * kB * g.w + nx * kB;
#pragma unroll
  for (int dy = 0; dy < kB; ++dy) {
#pragma unroll
    for (int dx = 0; dx < kB; ++dx) {
      if (ny * kB + dy < g.h && nx * kB + dx < g.w) {
        const long long at = base + static_cast<long long>(dy) * g.w + dx;
        out[at] = mask[at] ? v : -1;     // a background node: v = -1
      }
    }
  }
}

template <int kB, bool kIndex>
void launch(const uint8_t* mask, const int* values, int* out, int* scratch,
            int m, int h, int w, cudaStream_t s) {
  Grid g;
  g.h = h;
  g.w = w;
  g.nh = (h + kB - 1) / kB;
  g.nw = (w + kB - 1) / kB;
  g.tiles_y = (g.nh + kTileN - 1) / kTileN;
  g.tiles_x = (g.nw + kTileN - 1) / kTileN;
  g.m = m;
  const int n_nodes = m * g.nh * g.nw;
  int* parent = scratch;
  int* minv = scratch + n_nodes;
  const dim3 tiles(g.tiles_x, g.tiles_y, m);
  cc_tile<kB, kIndex><<<tiles, kTileThreads, 0, s>>>(mask, values, parent,
                                                      minv, g);
  const long long n_slots = static_cast<long long>(g.tiles_x) * g.tiles_y
      * m * kBorderSlots;
  cc_borders<kB><<<static_cast<unsigned>((n_slots + kFlatThreads - 1)
                                         / kFlatThreads),
                   kFlatThreads, 0, s>>>(mask, parent, g, n_slots);
  const unsigned blocks = (n_nodes + kFlatThreads - 1) / kFlatThreads;
  cc_roots<<<blocks, kFlatThreads, 0, s>>>(parent, minv, n_nodes);
  cc_gather<kB><<<blocks, kFlatThreads, 0, s>>>(mask, parent, minv, out, g);
}

// m masks in the tile grid's z, its rows of tiles in y
bool bad_shape(int m, int h, int w, int connectivity) {
  const int tile_rows = kTileN * (connectivity == 8 ? 2 : 1);
  return m <= 0 || h <= 0 || w <= 0 || m > 65535
      || static_cast<long long>(m) * h * w > INT_MAX
      || (connectivity != 8 && connectivity != 4)
      || (h + tile_rows - 1) / tile_rows > 65535;
}

}  // namespace

// mask: (m, h, w) uint8 (nonzero = foreground); values: (m, h, w) int32;
// out: (m, h, w) int32; scratch: 2 * m * nh * nw int32 (a parent and a
// minimum per node; nodes are 2 x 2 pixel blocks for connectivity 8,
// pixels for 4). m * h * w must fit in int32, m in 65535 and the rows of
// tiles in 65535. Returns the cudaError_t of the launches.
extern "C" int ccmin_prop_launch(const void* mask, const void* values,
                                 void* out, void* scratch, int m, int h,
                                 int w, int connectivity, void* stream) {
  if (bad_shape(m, h, w, connectivity)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto mk = static_cast<const uint8_t*>(mask);
  auto v = static_cast<const int*>(values);
  auto o = static_cast<int*>(out);
  auto sc = static_cast<int*>(scratch);
  if (connectivity == 8) {
    launch<2, false>(mk, v, o, sc, m, h, w, s);
  } else {
    launch<1, false>(mk, v, o, sc, m, h, w, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// mask: (m, h, w) uint8 (nonzero = foreground); out: (m, h, w) int32
// labels; scratch as for ccmin_prop_launch. m * h * w must fit in int32,
// m in 65535 and the rows of tiles in 65535. Returns the cudaError_t of
// the launches.
extern "C" int cc_labels_launch(const void* mask, void* out, void* scratch,
                                int m, int h, int w, int connectivity,
                                void* stream) {
  if (bad_shape(m, h, w, connectivity)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  auto mk = static_cast<const uint8_t*>(mask);
  auto o = static_cast<int*>(out);
  auto sc = static_cast<int*>(scratch);
  if (connectivity == 8) {
    launch<2, true>(mk, nullptr, o, sc, m, h, w, s);
  } else {
    launch<1, true>(mk, nullptr, o, sc, m, h, w, s);
  }
  return static_cast<int>(cudaGetLastError());
}
