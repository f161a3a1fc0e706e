// Nearest-centroid assignment fused with deterministic per-cluster partial
// sums and counts, for K-Means, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel tpumr/ops/kmeans.py::_assign_kernel (:57-63,
// launched by pallas_assign) together with the one-hot sums and counts that
// tpumr/ops/kmeans.py::assign_and_partials takes around it (:108-113). In one
// pass over the points it writes
//     ids[p]      = argmin_j |x_p|^2 - 2 x_p.c_j + |c_j|^2   (f32, strict '<'
//                   over j in order, so ties go to the lowest index)
//     sums[j][t]  = sum of x_p[t] over the points with ids[p] == j   (f32)
//     counts[j]   = number of points with ids[p] == j              (int32)
// for d <= 32 and k <= 64 (the wrapper routes every other shape to
// kmeans_assign.cu and a one-hot product).
//
// Bound on this card: memory. At the main path's split shape (n = 4,000,000,
// d = 16, k = 16) the function reads 256 MB of points and writes 16 MB of ids
// (the sums and counts are 1 KB; the per-block partials add about 0.3 MB),
// about 272 MB, or 81 us at 3.35 TB/s. Its 2nkd = 2.05 GFLOP of distances and
// nd additions of sums take about 32 us on the fp32 cores (67 TFLOP/s).
//
// Design:
// - Row width is a template parameter DP in {4, 8, 16, 32} (d <= DP, rows
//   zero-padded in registers), so the loops over a row are unrolled at their
//   real width and nothing spills.
// - A persistent grid: B blocks, as many as fit on the card at once, and
//   more only so that no block walks more than kMaxTilesPerBlock tiles. B
//   depends on n, d, k and the card alone. Each block stages the centroids
//   (zero-padded to DP) and their squared norms in shared memory once and
//   walks tiles blockIdx.x, blockIdx.x + B, ...
// - A tile is kTile consecutive points, one contiguous stretch of memory. It
//   is copied into shared memory with cp.async (16-byte copies where the
//   stretch is 16-byte aligned, 4-byte copies for a ragged end), double
//   buffered: the next tile is in flight while this one is reduced.
// - Phase A: each of the first kTile / P threads takes P points of the tile
//   (P = 4, or 2 at DP = 32). Every centroid is read from shared memory once
//   for P points: those broadcast reads, not the FMAs, bound this phase. It
//   writes each id to global memory (coalesced) and to shared memory, and
//   each warp counts its ids with __match_any_sync into its own row of
//   shared counters (integers: exact in any order).
// - Phase B: thread (g, t), t = dimension, g = sub-tile, adds x[p][t] for
//   the points p = s*G + g of the tile, s in order, into its own shared
//   accumulator acc[g][ids[p]][t]. Every accumulator has one writer, so
//   there are no atomics, and each takes its points in a fixed order. A full
//   tile goes four points at a time: four loads, then the four additions in
//   order with a repeated cluster forwarded in registers, then four stores.
//   Interleaved sub-tiles keep the threads of a warp on different banks.
// - At the end the block sums its G sub-tile accumulators in order into its
//   column of the partials [k*d, B] f32 and [k, B] int32. A second kernel
//   gives each output one block: thread t sums columns t, t + 256, ... in
//   order, then a fixed tree over the threads. No f32 accumulator takes more
//   than about 2,000 terms in a row, and the result is the same bits from
//   launch to launch.
// There are no float atomics anywhere.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 512;               // points per tile
constexpr int kMaxD = 32;
constexpr int kMaxK = 64;
constexpr int kMaxTilesPerBlock = 32;    // bounds the terms per accumulator

// Points of tile `tile`: kTile, or fewer at the ragged end.
__device__ __forceinline__ int tile_points(int tile, int n) {
  const int64_t left = n - (int64_t)tile * kTile;
  return left < kTile ? (int)left : kTile;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Shared memory of one block, in floats: two tile buffers, the sub-tile
// accumulators, the padded centroids, their norms, the counts and the ids.
template <int DP>
constexpr size_t smem_floats(int k) {
  return 2 * (size_t)kTile * DP + (size_t)kThreads * k  // bufs, acc[G][k][DP]
         + (size_t)k * DP + k                          // cent, c2
         + (size_t)kWarps * k + kTile;                 // cnt[warp][k], ids
}

// Copies the floats [0, m) of src (m = points * d) into dst.
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int m, bool aligned) {
  int vec = 0;
  if (aligned) {
    vec = m / 4;
    for (int i = threadIdx.x; i < vec; i += kThreads)
      cp_async16(dst + 4 * i, src + 4 * i);
    vec *= 4;
  }
  for (int i = vec + threadIdx.x; i < m; i += kThreads)
    cp_async4(dst + i, src + i);
}

// Phase A: points tid + q * kTile / P, q < P, of the tile in `cur`.
template <int DP, bool kFull>
__device__ __forceinline__ void assign_tile(const float* cur,
                                            const float* cent,
                                            const float* c2, int* tids,
                                            int* cnt, int32_t* ids,
                                            int64_t lo, int npts, int d,
                                            int k) {
  constexpr int P = DP >= 32 ? 2 : 4;        // points per thread
  constexpr int kActive = kTile / P;         // a multiple of 32
  constexpr int kUnrollJ = DP >= 32 ? 8 : 2;
  const int tid = threadIdx.x;
  if (tid >= kActive) return;
  float x[P][DP], x2[P], best[P];
  int bj[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int p = tid + q * kActive;   // < kTile; rows past npts are unused
    if (kFull) {
      const float4* row = reinterpret_cast<const float4*>(cur + p * DP);
#pragma unroll
      for (int u = 0; u < DP / 4; ++u) {
        const float4 v = row[u];
        x[q][4 * u] = v.x;
        x[q][4 * u + 1] = v.y;
        x[q][4 * u + 2] = v.z;
        x[q][4 * u + 3] = v.w;
      }
    } else {
      const float* row = cur + p * d;
#pragma unroll
      for (int u = 0; u < DP; ++u) x[q][u] = u < d ? row[u] : 0.f;
    }
    x2[q] = 0.f;
#pragma unroll
    for (int u = 0; u < DP; ++u) x2[q] += x[q][u] * x[q][u];
    best[q] = INFINITY;
    bj[q] = 0;
  }
#pragma unroll kUnrollJ
  for (int j = 0; j < k; ++j) {
    const float4* c = reinterpret_cast<const float4*>(cent + j * DP);
    const float cj = c2[j];
    float dot[P];
#pragma unroll
    for (int q = 0; q < P; ++q) dot[q] = 0.f;
#pragma unroll
    for (int u = 0; u < DP / 4; ++u) {
      const float4 v = c[u];
#pragma unroll
      for (int q = 0; q < P; ++q) {
        dot[q] += x[q][4 * u] * v.x;
        dot[q] += x[q][4 * u + 1] * v.y;
        dot[q] += x[q][4 * u + 2] * v.z;
        dot[q] += x[q][4 * u + 3] * v.w;
      }
    }
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const float d2 = x2[q] - 2.f * dot[q] + cj;
      if (d2 < best[q]) {
        best[q] = d2;
        bj[q] = j;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int p = tid + q * kActive;
    const int key = p < npts ? bj[q] : -1;
    if (key >= 0) {
      tids[p] = key;
      ids[lo + p] = key;
    }
    const unsigned same = __match_any_sync(0xffffffffu, key);
    if (key >= 0 && (tid & 31) == __ffs(same) - 1)
      cnt[(tid >> 5) * k + key] += __popc(same);
  }
}

// Phase B: thread (g, t) adds dimension t of sub-tile g's points, in order,
// into acc[g][ids[p]][t].
template <int DP>
__device__ __forceinline__ void sum_tile(const float* cur, const int* tids,
                                         float* acc, int npts, int d,
                                         int k) {
  constexpr int G = kThreads / DP;   // sub-tiles
  constexpr int S = kTile / G;       // points of a sub-tile (a multiple of 4)
  const int g = threadIdx.x / DP, t = threadIdx.x % DP;
  if (t >= d) return;
  float* a = acc + g * k * DP + t;   // a[j * DP] is acc[g][j][t]
  if (npts == kTile) {
#pragma unroll
    for (int s = 0; s < S; s += 4) {
      const int p0 = s * G + g, p1 = p0 + G, p2 = p1 + G, p3 = p2 + G;
      const int j0 = tids[p0], j1 = tids[p1], j2 = tids[p2], j3 = tids[p3];
      const float x0 = cur[p0 * d + t], x1 = cur[p1 * d + t],
                  x2 = cur[p2 * d + t], x3 = cur[p3 * d + t];
      const float a0 = a[j0 * DP], a1 = a[j1 * DP], a2 = a[j2 * DP],
                  a3 = a[j3 * DP];
      // each addition takes the newest value of its accumulator: the one
      // just computed when an earlier point of the four had its cluster
      const float v0 = a0 + x0;
      const float v1 = (j1 == j0 ? v0 : a1) + x1;
      const float v2 = (j2 == j1 ? v1 : j2 == j0 ? v0 : a2) + x2;
      const float v3 =
          (j3 == j2 ? v2 : j3 == j1 ? v1 : j3 == j0 ? v0 : a3) + x3;
      a[j0 * DP] = v0;   // stores in point order: the newest value wins
      a[j1 * DP] = v1;
      a[j2 * DP] = v2;
      a[j3 * DP] = v3;
    }
  } else {
    for (int s = 0; s < S; ++s) {
      const int p = s * G + g;
      if (p < npts) a[tids[p] * DP] += cur[p * d + t];
    }
  }
}

template <int DP, bool kFull>
__global__ void __launch_bounds__(kThreads)
    assign_partials_kernel(const float* __restrict__ points,
                           const float* __restrict__ centroids,
                           int32_t* __restrict__ ids,
                           float* __restrict__ part_sums,
                           int32_t* __restrict__ part_counts, int n, int d,
                           int k) {
  constexpr int G = kThreads / DP;
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);        // [2][kTile * DP]
  float* acc = buf + 2 * kTile * DP;                   // [G][k][DP]
  float* cent = acc + (size_t)kThreads * k;            // [k][DP]
  float* c2 = cent + k * DP;                           // [k]
  int* cnt = reinterpret_cast<int*>(c2 + k);           // [kWarps][k]
  int* tids = cnt + kWarps * k;                        // [kTile]

  const int tid = threadIdx.x;
  const int tiles = (int)(((int64_t)n + kTile - 1) / kTile);
  const bool aligned = (reinterpret_cast<uintptr_t>(points) & 15) == 0;

  int tile = blockIdx.x;
  load_tile(buf, points + (int64_t)tile * kTile * d, tile_points(tile, n) * d,
            aligned);
  cp_async_commit();

  for (int i = tid; i < kThreads * k; i += kThreads) acc[i] = 0.f;
  for (int i = tid; i < kWarps * k; i += kThreads) cnt[i] = 0;
  for (int i = tid; i < k * DP; i += kThreads) {
    const int j = i / DP, t = i % DP;
    cent[i] = t < d ? centroids[j * d + t] : 0.f;
  }
  __syncthreads();
  for (int j = tid; j < k; j += kThreads) {
    float s = 0.f;
    for (int t = 0; t < d; ++t) {
      const float v = cent[j * DP + t];
      s += v * v;
    }
    c2[j] = s;
  }

  for (int it = 0; tile < tiles; tile += gridDim.x, ++it) {
    const float* cur = buf + (it & 1) * kTile * DP;
    const int next = tile + gridDim.x;
    if (next < tiles) {
      load_tile(buf + ((it + 1) & 1) * kTile * DP,
                points + (int64_t)next * kTile * d, tile_points(next, n) * d,
                aligned);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();   // this tile has landed (and c2 is ready, first time)
    const int npts = tile_points(tile, n);
    assign_tile<DP, kFull>(cur, cent, c2, tids, cnt, ids,
                           (int64_t)tile * kTile, npts, d, k);
    __syncthreads();
    sum_tile<DP>(cur, tids, acc, npts, d, k);
    __syncthreads();   // before the next iteration overwrites this buffer
  }

  // The block's partials: its sub-tile accumulators summed in order.
  const int kd = k * d;
  for (int i = tid; i < kd; i += kThreads) {
    const int j = i / d, u = i % d;
    float s = 0.f;
    for (int h = 0; h < G; ++h) s += acc[(h * k + j) * DP + u];
    part_sums[(size_t)i * gridDim.x + blockIdx.x] = s;
  }
  for (int j = tid; j < k; j += kThreads) {
    int c = 0;
    for (int w = 0; w < kWarps; ++w) c += cnt[w * k + j];
    part_counts[(size_t)j * gridDim.x + blockIdx.x] = c;
  }
}

// Output i (a sum, or past k*d a count) is summed by block i: thread t over
// the partials' columns t, t + 256, ... in order, then a fixed tree over the
// threads.
__global__ void __launch_bounds__(kThreads)
    reduce_partials_kernel(const float* __restrict__ part_sums,
                           const int32_t* __restrict__ part_counts,
                           float* __restrict__ sums,
                           int32_t* __restrict__ counts, int blocks, int kd) {
  __shared__ float fs[kThreads];
  __shared__ int is[kThreads];
  const int i = blockIdx.x, tid = threadIdx.x;
  if (i < kd) {
    const float* row = part_sums + (size_t)i * blocks;
    float s = 0.f;
    for (int b = tid; b < blocks; b += kThreads) s += row[b];
    fs[tid] = s;
    __syncthreads();
    for (int w = kThreads / 2; w > 0; w >>= 1) {
      if (tid < w) fs[tid] += fs[tid + w];
      __syncthreads();
    }
    if (tid == 0) sums[i] = fs[0];
  } else {
    const int32_t* row = part_counts + (size_t)(i - kd) * blocks;
    int c = 0;
    for (int b = tid; b < blocks; b += kThreads) c += row[b];
    is[tid] = c;
    __syncthreads();
    for (int w = kThreads / 2; w > 0; w >>= 1) {
      if (tid < w) is[tid] += is[tid + w];
      __syncthreads();
    }
    if (tid == 0) counts[i - kd] = is[0];
  }
}

template <int DP, bool kFull>
int set_smem(int k, size_t* smem) {
  *smem = smem_floats<DP>(k) * sizeof(float);
  return (int)cudaFuncSetAttribute(
      assign_partials_kernel<DP, kFull>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

template <int DP, bool kFull>
int resident_blocks(int k, int* resident) {
  size_t smem = 0;
  cudaError_t e = (cudaError_t)set_smem<DP, kFull>(k, &smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, assign_partials_kernel<DP, kFull>, kThreads, smem)) !=
      cudaSuccess)
    return (int)e;
  *resident = (per_sm > 0 ? per_sm : 1) * sms;
  return 0;
}

template <int DP, bool kFull>
int launch(const float* points, const float* centroids, int32_t* ids,
           float* part_sums, int32_t* part_counts, int n, int d, int k,
           int blocks, cudaStream_t stream) {
  size_t smem = 0;
  const int rc = set_smem<DP, kFull>(k, &smem);
  if (rc != 0) return rc;
  assign_partials_kernel<DP, kFull><<<blocks, kThreads, smem, stream>>>(
      points, centroids, ids, part_sums, part_counts, n, d, k);
  return (int)cudaGetLastError();
}

// The (DP, kFull) instance for width d: d itself when it is 4, 8, 16 or 32
// (rows read as float4), else the next of those with a guarded scalar read.
#define KMEANS_DISPATCH(d, CALL) \
  ((d) == 4    ? CALL(4, true)   \
   : (d) < 4   ? CALL(4, false)  \
   : (d) == 8  ? CALL(8, true)   \
   : (d) < 8   ? CALL(8, false)  \
   : (d) == 16 ? CALL(16, true)  \
   : (d) < 16  ? CALL(16, false) \
   : (d) == 32 ? CALL(32, true)  \
               : CALL(32, false))

int64_t tile_count(int n) { return ((int64_t)n + kTile - 1) / kTile; }

bool in_range(int n, int d, int k) {
  return n > 0 && d > 0 && d <= kMaxD && k > 0 && k <= kMaxK;
}

}  // namespace

// Blocks of the fused kernel's grid for n points of width d and k centroids
// on the current device, the partials' second dimension: as many as fit on
// the card at once, or more so that no block walks more than
// kMaxTilesPerBlock tiles, and never more than there are tiles. Writes it to
// *blocks and returns a cudaError_t (0 on success).
extern "C" int kmeans_assign_partials_blocks(int n, int d, int k,
                                             int* blocks) {
  if (!in_range(n, d, k)) return (int)cudaErrorInvalidValue;
  int resident = 0;
#define RESIDENT(DP, FULL) resident_blocks<DP, FULL>(k, &resident)
  const int rc = KMEANS_DISPATCH(d, RESIDENT);
#undef RESIDENT
  if (rc != 0) return rc;
  const int64_t tiles = tile_count(n);
  const int64_t b = tiles < resident ? tiles : resident;
  const int64_t least = (tiles + kMaxTilesPerBlock - 1) / kMaxTilesPerBlock;
  *blocks = (int)(b > least ? b : least);
  return 0;
}

// points [n, d] f32, centroids [k, d] f32 -> ids [n] int32, sums [k, d] f32,
// counts [k] int32, through partials [k*d, blocks] f32 and [k, blocks]
// int32, where blocks is kmeans_assign_partials_blocks(n, d, k). All
// contiguous, on the current device. Launches both kernels on `stream`,
// allocates nothing and does not synchronise. Returns the first launch
// error's cudaError_t (0 on success).
extern "C" int kmeans_assign_partials(const void* points,
                                      const void* centroids, void* ids,
                                      void* part_sums, void* part_counts,
                                      void* sums, void* counts, int n, int d,
                                      int k, int blocks, void* stream) {
  if (!in_range(n, d, k) || blocks < 1 || blocks > tile_count(n))
    return (int)cudaErrorInvalidValue;
  const float* p = static_cast<const float*>(points);
  const float* c = static_cast<const float*>(centroids);
  int32_t* o = static_cast<int32_t*>(ids);
  float* ps = static_cast<float*>(part_sums);
  int32_t* pc = static_cast<int32_t*>(part_counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(DP, FULL) \
  launch<DP, FULL>(p, c, o, ps, pc, n, d, k, blocks, s)
  const int rc = KMEANS_DISPATCH(d, LAUNCH);
#undef LAUNCH
  if (rc != 0) return rc;
  reduce_partials_kernel<<<k * d + k, kThreads, 0, s>>>(
      ps, pc, static_cast<float*>(sums), static_cast<int32_t*>(counts),
      blocks, k * d);
  return (int)cudaGetLastError();
}
