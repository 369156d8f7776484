// hist_dense and keep_lut: the component-area histogram and the keep-bit
// lookup of the batched min-area removal.
//
//   hist_dense: (M, N) int32 ids -> (M, bins) int32 exact counts of each
//     id in [0, bins) per mask; negative ids and ids >= bins not counted.
//   keep_lut:   (M, N) int32 ids + (M, bins) uint8 0/1 table -> (M, N)
//     int32 keep bits; ids outside [0, bins) read 0.
//
// Replaces: rs_image_segmentation_tpu/ops/pallas_kernels.py
//   hist_dense_pallas (_hist_dense_kernel) and keep_lut_pallas
//   (_keep_lut_kernel). The TPU computed both as one-hot (hi, lo) matmuls
//   on the MXU, because a scatter or a gather is slow there; a Hopper SM
//   has shared-memory atomics and cached gathers, so neither needs the
//   one-hot form nor the bins tiers that cut its cost.
//
// What bounds them on an H100: bytes. At the rule path's first stage
// (24 masks x 360 000 ids, bins 32768) hist_dense reads 34.6 MB of ids and
// writes 3.1 MB of counts (about 11 us at 3.35 TB/s); keep_lut reads the
// ids and writes 34.6 MB of bits (about 21 us).
//
// hist_dense, what held the first design back: one block per slice of a
// mask kept a private histogram of all `bins` in shared memory (128 KB at
// 32768 bins), so one 1024-thread block fit on an SM; each thread loaded
// 4 bytes and then waited on __match_any_sync and a shared atomic before
// its next load, about 4 KB in flight per SM where 3.35 TB/s at ~0.7 us
// of latency asks for ~18 KB. Every block also zeroed and scanned all
// `bins` (shared traffic twice the ids), and the output needed a memset
// launch because blocks added into it.
//
// What the cluster instance (hist_cluster_kernel) does about it:
//   * One thread-block cluster of kCluster blocks per mask. The mask's
//     bins are split across the cluster's shared memories in granules of
//     128: block r owns granules r, r + kCluster, ... (bpb bins, 4096 and
//     16 KB at 32768 bins). A block zeroes only its own bins. Component
//     ids are dense from 0, so owning contiguous ranges would send a
//     mask's atomics to one or two blocks; interleaved granules spread
//     them over the cluster.
//   * Each block reads one contiguous slice of the mask's ids in steps of
//     kClusterThreads * kUnroll 16-byte words, each thread kUnroll
//     consecutive words a step (64 bytes), all in flight before any atomic
//     (32 KB a block). It adds its counts into the owning block's shared
//     memory with atomics through distributed shared memory
//     (cluster.map_shared_rank), between two cluster barriers.
//   * A thread merges runs of equal ids in registers, across its steps
//     too, and issues one atomic per run; ids outside [0, bins) are skipped
//     before any atomic. Ids are constant along row runs of a component,
//     and the background id (bins) never reaches an atomic. A remote
//     atomic costs more than a load, so the count of runs sets the time
//     above the streaming floor: on the rule path's first stage 16
//     consecutive ids a thread need 316 K atomics, 4 (words strided across
//     the block) 585 K; a whole contiguous chunk a thread (226 K) loses
//     more in uncoalesced loads than it saves.
//   * Every bin is written exactly once, by its owner, with coalesced
//     16-byte stores: the output is allocated uninitialised (no memset).
//   * At 24 masks x 8 blocks of 512 threads with 16 KB each, every block
//     is resident at once (one wave).
//   Integer atomics are exact in any order, so the counts are exact.
//
// The global instance (hist_global_kernel) takes every shape the cluster
// instance does not: bins past kClusterMaxBins, ids whose base is not
// 16-byte aligned or n % 4 != 0, and a single mask (one cluster would use
// 8 SMs). Its blocks count straight into the output with global atomics,
// lanes holding one id merged by __match_any_sync; the output must be
// zeroed first. The caller picks the instance by shape
// (ops/kernels.py::hist_dense_instance) and passes span4 = 0 for it.
//
// keep_lut: a streaming pass, 16 bytes of ids in and 16 bytes of bits out
// per thread where alignment allows; the table reads go through the
// read-only cache (32 KB per mask at 32768 bins).

#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;            // blocks per mask (HIST_CLUSTER)
constexpr int kClusterThreads = 512;   // HIST_THREADS
constexpr int kUnroll = 4;             // HIST_UNROLL: int4 loads in flight
constexpr int kClusterMaxBins = kCluster * 12288;  // 48 KB a block
constexpr int kGlobalThreads = 1024;
constexpr int kKeepThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// One run of equal in-range ids, merged in registers; flushed with one
// atomic into the owning block's shared memory.
struct Run {
  int id = -1;
  int count = 0;
};

// Bin id lies in granule g = id / 128; granule g belongs to block
// g % kCluster, at its local granule g / kCluster.
__device__ __forceinline__ void flush(const cg::cluster_group& cluster,
                                      int* s_hist, const Run& r) {
  const int g = r.id >> 7;
  int* dst = cluster.map_shared_rank(s_hist, g % kCluster);
  atomicAdd(dst + ((g / kCluster) << 7) + (r.id & 127), r.count);
}

__device__ __forceinline__ void add(const cg::cluster_group& cluster,
                                    int* s_hist, int bins, Run& r, int id) {
  if (static_cast<unsigned>(id) >= static_cast<unsigned>(bins)) return;
  if (id == r.id) {
    ++r.count;
    return;
  }
  if (r.count) flush(cluster, s_hist, r);
  r.id = id;
  r.count = 1;
}

__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(kClusterThreads)
hist_cluster_kernel(const int4* __restrict__ ids, int* __restrict__ counts,
                    long long n4, int bins, long long span4, int bpb) {
  extern __shared__ int4 s_hist4[];      // this block's bpb bins
  int* s_hist = reinterpret_cast<int*>(s_hist4);
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long m = blockIdx.y;
  for (int i = threadIdx.x; i < bpb / 4; i += kClusterThreads) {
    s_hist4[i] = make_int4(0, 0, 0, 0);
  }
  cluster.sync();                        // every slice zeroed, every block up

  // this block's words [lo, hi) of the mask; a step of the block covers
  // kClusterThreads * kUnroll words, kUnroll consecutive ones a thread
  const int4* src = ids + m * n4;
  const long long lo = rank * span4;
  const long long hi = lo + span4 < n4 ? lo + span4 : n4;
  Run run;
  for (long long base = lo + threadIdx.x * kUnroll; base < hi;
       base += kClusterThreads * kUnroll) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u;
      v[u] = i < hi ? __ldg(src + i) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      add(cluster, s_hist, bins, run, v[u].x);
      add(cluster, s_hist, bins, run, v[u].y);
      add(cluster, s_hist, bins, run, v[u].z);
      add(cluster, s_hist, bins, run, v[u].w);
    }
  }
  if (run.count) flush(cluster, s_hist, run);
  cluster.sync();                        // every count is in its owner

  // this block's granules rank, rank + kCluster, ..., 32 int4 each
  int4* out = reinterpret_cast<int4*>(counts + m * bins);
  const int granules = bins >> 7;
  for (int i = threadIdx.x; i < bpb / 4; i += kClusterThreads) {
    const int g = (i >> 5) * kCluster + rank;
    if (g < granules) out[(g << 5) + (i & 31)] = s_hist4[i];
  }
}

__global__ void __launch_bounds__(kGlobalThreads)
hist_global_kernel(const int* __restrict__ ids, int* __restrict__ counts,
                   long long n, int bins, long long span) {
  const int m = blockIdx.y;
  int* dst = counts + static_cast<long long>(m) * bins;
  const int* src = ids + static_cast<long long>(m) * n;
  const long long lo = blockIdx.x * span;
  const long long hi = lo + span < n ? lo + span : n;
  const int lane = threadIdx.x & 31;
  // every lane runs the same number of steps: the warp intrinsics need all
  for (long long base = lo; base < hi; base += kGlobalThreads) {
    const long long i = base + threadIdx.x;
    const int id = i < hi ? src[i] : -1;
    const bool ok = static_cast<unsigned>(id) < static_cast<unsigned>(bins);
    const unsigned peers = __match_any_sync(kFull, ok ? id : -1);
    if (ok && lane == __ffs(peers) - 1) atomicAdd(&dst[id], __popc(peers));
  }
}

__device__ __forceinline__ int keep_bit(const uint8_t* tab, int id,
                                        int bins) {
  return static_cast<unsigned>(id) < static_cast<unsigned>(bins)
      ? static_cast<int>(__ldg(tab + id) != 0) : 0;
}

template <bool kVec>
__global__ void __launch_bounds__(kKeepThreads)
keep_lut_kernel(const int* __restrict__ ids, const uint8_t* __restrict__ table,
                int* __restrict__ out, long long n, int bins) {
  const long long m = blockIdx.y;
  const int* src = ids + m * n;
  int* dst = out + m * n;
  const uint8_t* tab = table + m * bins;
  const long long step = static_cast<long long>(gridDim.x) * kKeepThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kKeepThreads + threadIdx.x;
  if (kVec) {
    // n % 4 == 0 and both bases 16-byte aligned (checked by the host)
    const int4* src4 = reinterpret_cast<const int4*>(src);
    int4* dst4 = reinterpret_cast<int4*>(dst);
    for (long long i = first; i < n / 4; i += step) {
      const int4 v = src4[i];
      dst4[i] = make_int4(keep_bit(tab, v.x, bins), keep_bit(tab, v.y, bins),
                          keep_bit(tab, v.z, bins), keep_bit(tab, v.w, bins));
    }
  } else {
    for (long long i = first; i < n; i += step) {
      dst[i] = keep_bit(tab, src[i], bins);
    }
  }
}

int sm_count() {
  int dev = 0;
  int sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

}  // namespace

// ids: (m, n) int32; counts: (m, bins) int32. span4 > 0 takes the cluster
// instance: ids 16-byte aligned, n % 4 == 0, m >= 2, bins <= the cluster
// limit, bins and bpb multiples of 128, span4 = ceil(n / 4 / kCluster),
// bpb = ceil(bins / (kCluster * 128)) * 128; counts may hold anything.
// span4 == 0 takes the global instance; counts must be zero-filled.
// Returns the cudaError_t of the launch.
extern "C" int hist_dense_launch(const void* ids, void* counts, int m,
                                 long long n, int bins, long long span4,
                                 int bpb, void* stream) {
  if (m <= 0 || m > 65535 || n <= 0 || bins <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (span4 > 0) {
    const long long n4 = n / 4;
    if (m < 2 || n % 4 != 0 || reinterpret_cast<uintptr_t>(ids) % 16 != 0
        || reinterpret_cast<uintptr_t>(counts) % 16 != 0
        || bins > kClusterMaxBins || bins % 128 != 0
        || span4 != (n4 + kCluster - 1) / kCluster
        || bpb != (bins + kCluster * 128 - 1) / (kCluster * 128) * 128) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid(kCluster, static_cast<unsigned>(m));
    hist_cluster_kernel<<<grid, kClusterThreads, bpb * sizeof(int), s>>>(
        static_cast<const int4*>(ids), static_cast<int*>(counts), n4, bins,
        span4, bpb);
    return static_cast<int>(cudaGetLastError());
  }
  // about two blocks per SM over the whole batch, each slice a multiple
  // of the block's width
  long long per_mask = (2LL * sm_count() + m - 1) / m;
  const long long most = (n + kGlobalThreads - 1) / kGlobalThreads;
  if (per_mask > most) per_mask = most;
  long long span = (n + per_mask - 1) / per_mask;
  span = (span + kGlobalThreads - 1) / kGlobalThreads * kGlobalThreads;
  const dim3 grid(static_cast<unsigned>((n + span - 1) / span),
                  static_cast<unsigned>(m));
  hist_global_kernel<<<grid, kGlobalThreads, 0, s>>>(
      static_cast<const int*>(ids), static_cast<int*>(counts), n, bins, span);
  return static_cast<int>(cudaGetLastError());
}

// ids: (m, n) int32; table: (m, bins) uint8 (0/1); out: (m, n) int32.
// Returns the cudaError_t of the launch.
extern "C" int keep_lut_launch(const void* ids, const void* table, void* out,
                               int m, long long n, int bins, void* stream) {
  if (m <= 0 || m > 65535 || n <= 0 || bins <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = n % 4 == 0
      && reinterpret_cast<uintptr_t>(ids) % 16 == 0
      && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long units = vec ? n / 4 : n;
  long long bx = (units + kKeepThreads - 1) / kKeepThreads;
  const long long cap = (8LL * sm_count() + m - 1) / m;
  if (bx > cap) bx = cap;
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(m));
  auto s = static_cast<cudaStream_t>(stream);
  auto src = static_cast<const int*>(ids);
  auto tab = static_cast<const uint8_t*>(table);
  auto dst = static_cast<int*>(out);
  if (vec) {
    keep_lut_kernel<true><<<grid, kKeepThreads, 0, s>>>(src, tab, dst, n, bins);
  } else {
    keep_lut_kernel<false><<<grid, kKeepThreads, 0, s>>>(src, tab, dst, n,
                                                         bins);
  }
  return static_cast<int>(cudaGetLastError());
}
