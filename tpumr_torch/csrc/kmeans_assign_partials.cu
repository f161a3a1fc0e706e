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
// Bound on this card: memory, in principle. At the main path's split shape
// (n = 4,000,000, d = 16, k = 16) the function reads 256 MB of points and
// writes 16 MB of ids (the sums and counts are 1 KB), 272 MB, or 81 us at
// 3.35 TB/s; its 2nkd = 2.05 GFLOP of distances take about 31 us on the
// fp32 cores (67 TFLOP/s). In practice the instructions bound it: timed on
// an H100 with its loads switched off, the kernel computes for longer than
// its copy takes. So the design spends instructions sparingly.
//
// The design before this one assigned on half the block (128 threads, 4
// points each), read rows at a 64-byte stride (four threads to a bank),
// then summed in a second phase, three barriers a tile and one tile in
// flight. This one:
// - Every thread assigns 2 points of a 512-point tile, so an SM runs 16
//   assigning warps (8 at DP = 32, where one block fits), and every
//   centroid read from shared memory (a broadcast) serves 2 points. The
//   centroids are walked kUnrollJ at a time.
// - A tile's rows are stored swizzled: the 16-byte chunk c of row p sits at
//   chunk c ^ swizzle(p) of its row, so a quarter-warp's 16-byte reads of 8
//   consecutive rows touch every bank once. cp.async 16-byte copies write
//   that layout (4-byte copies for an unaligned base); a thread's copies of
//   a tile lie a multiple of 8 rows apart and share one swizzle, so each
//   takes two additions of address arithmetic. A tile is one contiguous
//   stretch of memory.
// - The sums of the previous tile run between groups of centroids, where
//   the fp32 pipes are busy and shared memory is not: sum thread (g, t), t
//   a dimension, g one of G sub-tiles, adds dimension t of sub-tile g's
//   points, 4 at a time and in order, into its own accumulator
//   acc[cluster][g][t] (one writer each, so no atomics; cluster-major, so
//   the sub-tiles of a warp fall on different banks). The one-hot product
//   on the tensor cores (mma.sync m16n8k8 TF32 with x split in two, chains
//   of one tile) was built and measured for these sums and cost more: each
//   8 points took 4 mma and some 40 instructions to build fragments, where
//   these sums take about 5 a point and dimension.
// - A ring of kStages tiles: with 3, tile i + 1 is in flight while tile i
//   is assigned and tile i - 1 summed, one barrier a tile. Rows of 32
//   floats leave room for 2 only: the previous tile's sums then go in the
//   first half of the walk, after which a second barrier frees its stage
//   for the next copy.
// - The grid, tile and shared memory come from a plan computed once per
//   shape and card (tpumr_torch/ops/kmeans.py::fused_plan); the entry point
//   checks it and sets the shared-memory attribute once per instance and
//   device, so a launch makes no occupancy query.
//
// Determinism: the grid, the point-to-thread mapping and every summation
// order are fixed by the shape and the plan. Each block walks tiles
// blockIdx.x, blockIdx.x + B, ...; sums its G sub-tile accumulators in
// order into its column of the partials [k*d, B] f32 and [k, B] int32; a
// second kernel gives each output one block, which sums the columns in a
// fixed order and tree. There are no float atomics anywhere, and two
// launches on one input give the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 512;               // points a tile
constexpr int P = kTile / kThreads;      // points a thread assigns
constexpr int kMaxD = 32;
constexpr int kMaxK = 64;
constexpr int kMaxTilesPerBlock = 32;    // bounds the terms of an accumulator
constexpr int kMaxSmem = 232448;         // dynamic shared memory of a block
constexpr int kMaxDevices = 64;
constexpr unsigned kAll = 0xffffffffu;

// What each row width DP in {4, 8, 16, 32} takes.
template <int DP>
struct Width {
  static constexpr int kStages = DP >= 32 ? 2 : 3;  // tiles of the ring
  // threads that sum: (g, t), G sub-tiles by DP dimensions (at DP = 16 half
  // the block, which keeps two blocks' rings and accumulators on an SM)
  static constexpr int kSumThreads = DP == 16 ? 128 : kThreads;
  static constexpr int G = kSumThreads / DP;
  static constexpr int kChunks = kTile / G / 4;   // a sub-tile, 4 at a time
  static constexpr int kMinBlocks = DP >= 32 ? 1 : 2;
  static constexpr int kUnrollJ = DP >= 16 ? 8 : 2;
};

// Floats of shared memory: the ring, the accumulators [k][G][DP], two
// tiles of ids (int), the padded centroids, their norms, and each warp's
// counts (int).
template <int DP>
constexpr size_t smem_floats(int k) {
  return (size_t)Width<DP>::kStages * kTile * DP +
         (size_t)k * Width<DP>::G * DP + 2 * kTile + (size_t)k * DP + k +
         (size_t)kWarps * k;
}

// Points of tile `tile`: kTile, or fewer at the ragged end.
__device__ __forceinline__ int tile_points(int tile, int n) {
  const int64_t left = n - (int64_t)tile * kTile;
  return left < kTile ? (int)left : kTile;
}

// The 16-byte chunk of row p at which its chunk c is stored is
// c ^ swizzle(p), which depends on p's low 3 bits alone: over 8 consecutive
// rows every bank is used once.
template <int DP>
__device__ __forceinline__ int swizzle(int p) {
  constexpr int C = DP / 4;
  if (C == 1) return 0;
  if (C == 2) return (p >> 2) & 1;
  if (C == 4) return (((p >> 1) & 1) << 1) | ((p >> 2) & 1);
  return ((p & 3) << 1) | ((p >> 2) & 1);
}

// Float offset of (row, col) in a tile of full rows.
template <int DP>
__device__ __forceinline__ int xoff(int row, int col) {
  return row * DP + ((((col >> 2) ^ swizzle<DP>(row)) << 2) | (col & 3));
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Copies the npts points at src (rows of d floats) into dst: swizzled full
// rows where d == DP, else as they lie. One group of copies.
template <int DP, bool kFull>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int npts, int d, bool aligned) {
  const int tid = threadIdx.x;
  if (kFull) {
    constexpr int C = DP / 4;
    if (aligned) {
      // thread tid copies chunks tid + i * kThreads, chunk tid % C of rows
      // tid / C + i * kRows: kRows is a multiple of 8, so every row it
      // writes has its swizzle
      constexpr int kRows = kThreads / C;
      const int row = tid / C;
      float* to = dst + row * DP + (((tid % C) ^ swizzle<DP>(row)) << 2);
      const float* from = src + 4 * tid;
      const int chunks = npts * C;
#pragma unroll 4
      for (int g = tid; g < chunks; g += kThreads) {
        cp_async16(to, from);
        to += kRows * DP;
        from += 4 * kThreads;
      }
    } else {
      for (int i = tid; i < npts * DP; i += kThreads)
        cp_async4(dst + xoff<DP>(i / DP, i % DP), src + i);
    }
  } else {
    const int m = npts * d;
    int vec = 0;
    if (aligned) {
      vec = m / 4;
      for (int i = tid; i < vec; i += kThreads)
        cp_async16(dst + 4 * i, src + 4 * i);
      vec *= 4;
    }
    for (int i = vec + tid; i < m; i += kThreads)
      cp_async4(dst + i, src + i);
  }
  cp_async_commit();
}

// One sum thread's part of a tile's sums: dimension t of sub-tile g, whose
// points are s * G + g, s in order, into acc[ids[p]][g][t].
template <int DP, bool kFull>
struct TileSums {
  static constexpr int G = Width<DP>::G;
  const float* x;     // the tile
  const int* ids;     // its ids
  float* acc;         // &acc[0][g][t]
  int col;            // dimension t's offset in a row of sub-tile g
  int row;            // floats a row
  int npts;

  __device__ __forceinline__ void start(const float* tile, const int* tile_ids,
                                        float* accumulators, int n_pts,
                                        int d) {
    const int g = threadIdx.x / DP, t = threadIdx.x % DP;
    x = tile;
    ids = tile_ids;
    acc = accumulators + g * DP + t;
    // a row's swizzle depends on its low 3 bits, which are g's (G >= 8)
    col = kFull ? (((t >> 2) ^ swizzle<DP>(g)) << 2) | (t & 3) : t;
    row = kFull ? DP : d;
    npts = n_pts;
  }

  // Points 4c .. 4c + 3 of the sub-tile: four loads, the four additions in
  // order with a repeated cluster forwarded in registers, four stores.
  __device__ __forceinline__ void chunk(int c) const {
    constexpr int kStride = G * DP;   // acc[j + 1][g][t] - acc[j][g][t]
    const int g = threadIdx.x / DP;
    const int p0 = 4 * c * G + g, p1 = p0 + G, p2 = p1 + G, p3 = p2 + G;
    const int j0 = ids[p0], j1 = ids[p1], j2 = ids[p2], j3 = ids[p3];
    const int r = kFull ? DP : row;
    const float x0 = x[p0 * r + col], x1 = x[p1 * r + col],
                x2 = x[p2 * r + col], x3 = x[p3 * r + col];
    const float a0 = acc[j0 * kStride], a1 = acc[j1 * kStride],
                a2 = acc[j2 * kStride], a3 = acc[j3 * kStride];
    // each addition takes the newest value of its accumulator: the one
    // just computed when an earlier point of the four had its cluster
    const float v0 = a0 + x0;
    const float v1 = (j1 == j0 ? v0 : a1) + x1;
    const float v2 = (j2 == j1 ? v1 : j2 == j0 ? v0 : a2) + x2;
    const float v3 = (j3 == j2 ? v2 : j3 == j1 ? v1 : j3 == j0 ? v0 : a3) + x3;
    acc[j0 * kStride] = v0;   // stores in point order: the newest value wins
    acc[j1 * kStride] = v1;
    acc[j2 * kStride] = v2;
    acc[j3 * kStride] = v3;
  }

  // The ragged tile's sub-tile, one point at a time.
  __device__ __forceinline__ void ragged() const {
    constexpr int kStride = G * DP;
    const int g = threadIdx.x / DP;
    for (int p = g; p < npts; p += G) acc[ids[p] * kStride] += x[p * row + col];
  }
};

// Takes centroid j into each point's nearest so far: |x|^2 - 2 x.c + |c|^2
// in f32, the dot product in dimension order, strict '<'.
template <int DP>
__device__ __forceinline__ void nearer(const float* cent, const float* c2,
                                       int j, const float (&x)[P][DP],
                                       const float (&x2)[P], float (&best)[P],
                                       int (&bj)[P]) {
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
    // x2 - 2 dot rounded once: 2 dot is exact
    const float d2 = fmaf(-2.f, dot[q], x2[q]) + cj;
    if (d2 < best[q]) {
      best[q] = d2;
      bj[q] = j;
    }
  }
}

// Each block walks tiles blockIdx.x, blockIdx.x + B, ... Iteration i
// assigns tile i (thread tid: points tid and tid + 256) and, between its
// groups of centroids, the sum threads add tile i - 1.
template <int DP, bool kFull>
__global__ void __launch_bounds__(kThreads, Width<DP>::kMinBlocks)
    assign_partials_kernel(const float* __restrict__ points,
                           const float* __restrict__ centroids,
                           int32_t* __restrict__ ids,
                           float* __restrict__ part_sums,
                           int32_t* __restrict__ part_counts, int n, int d,
                           int k) {
  using W = Width<DP>;
  constexpr int S = W::kStages, U = W::kUnrollJ, kChunks = W::kChunks;
  constexpr int kStage = kTile * DP;   // floats of a ring stage
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);       // [S][kStage]
  float* acc = ring + S * kStage;                      // [k][G][DP]
  int* tids = reinterpret_cast<int*>(acc + k * W::G * DP);  // [2][kTile]
  float* cent = reinterpret_cast<float*>(tids + 2 * kTile);  // [k][DP]
  float* c2 = cent + k * DP;                           // [k]
  int* cnt = reinterpret_cast<int*>(c2 + k);           // [warp][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = (int)(((int64_t)n + kTile - 1) / kTile);
  const bool aligned = (reinterpret_cast<uintptr_t>(points) & 15) == 0;
  const int B = gridDim.x;
  // whether this thread sums, and the walk's groups of centroids
  const bool sums = tid < W::kSumThreads && (kFull || tid % DP < d);
  const int groups = k / U;
  const int spread = S == 3 ? groups : (groups + 1) / 2;   // groups that sum
  const int per = spread > 0 ? (kChunks + spread - 1) / spread : 0;

  load_tile<DP, kFull>(ring, points + (int64_t)blockIdx.x * kTile * d,
                       tile_points(blockIdx.x, n), d, aligned);
  for (int i = tid; i < k * W::G * DP; i += kThreads) acc[i] = 0.f;
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

  TileSums<DP, kFull> prev;
  bool summing = false;
  int stage = 0, parity = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += B) {
    cp_async_wait_all();
    __syncthreads();   // tile i is here; tile i - 2 is summed, its stage free
    const int next = tile + B;
    const int into = stage == S - 1 ? 0 : stage + 1;
    if (S == 3 && next < tiles)
      load_tile<DP, kFull>(ring + into * kStage,
                           points + (int64_t)next * kTile * d,
                           tile_points(next, n), d, aligned);

    const float* cur = ring + stage * kStage;
    const int npts = tile_points(tile, n);
    float x[P][DP], x2[P], best[P];
    int bj[P];
    const int sw = swizzle<DP>(tid);   // every row tid + q * kThreads's
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int p = tid + q * kThreads;   // rows past npts are read, unused
      if (kFull) {
#pragma unroll
        for (int u = 0; u < DP / 4; ++u) {
          const float4 v = *reinterpret_cast<const float4*>(
              cur + p * DP + ((u ^ sw) << 2));
          x[q][4 * u] = v.x;
          x[q][4 * u + 1] = v.y;
          x[q][4 * u + 2] = v.z;
          x[q][4 * u + 3] = v.w;
        }
      } else {
        const float* r = cur + p * d;
#pragma unroll
        for (int u = 0; u < DP; ++u) x[q][u] = u < d ? r[u] : 0.f;
      }
      x2[q] = 0.f;
#pragma unroll
      for (int u = 0; u < DP; ++u) x2[q] += x[q][u] * x[q][u];
      best[q] = INFINITY;
      bj[q] = 0;
    }
    // the walk: groups of U centroids, and the previous tile's sums in
    // chunks spread over the first `spread` groups; with 2 stages, a
    // barrier after them frees that tile's stage for the next copy
    int c = 0;
    for (int it = 0; it < groups; ++it) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        nearer<DP>(cent, c2, it * U + u, x, x2, best, bj);
      if (summing && sums)
        for (int e = 0; e < per && c < kChunks; ++e, ++c) prev.chunk(c);
      if (S == 2 && it == spread - 1) {
        __syncthreads();
        if (next < tiles)
          load_tile<DP, kFull>(ring + into * kStage,
                               points + (int64_t)next * kTile * d,
                               tile_points(next, n), d, aligned);
      }
    }
    for (int j = groups * U; j < k; ++j)
      nearer<DP>(cent, c2, j, x, x2, best, bj);
    if (summing && sums)
      for (; c < kChunks; ++c) prev.chunk(c);
    if (S == 2 && spread == 0) {
      __syncthreads();
      if (next < tiles)
        load_tile<DP, kFull>(ring + into * kStage,
                             points + (int64_t)next * kTile * d,
                             tile_points(next, n), d, aligned);
    }

    // ids: to global memory, to this tile's half of tids, counted by warp
    int* tile_ids = tids + parity * kTile;
    const int64_t lo = (int64_t)tile * kTile;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int p = tid + q * kThreads;
      const int key = p < npts ? bj[q] : -1;
      if (key >= 0) {
        ids[lo + p] = key;
        tile_ids[p] = key;
      }
      const unsigned same = __match_any_sync(kAll, key);
      if (key >= 0 && lane == __ffs(same) - 1)
        cnt[warp * k + key] += __popc(same);
      __syncwarp();
    }
    prev.start(cur, tile_ids, acc, npts, d);
    summing = true;
    stage = into;
    parity ^= 1;
  }
  // the block's last tile, which may be the ragged one
  cp_async_wait_all();
  __syncthreads();
  if (sums) {
    if (prev.npts == kTile) {
      for (int c = 0; c < kChunks; ++c) prev.chunk(c);
    } else {
      prev.ragged();
    }
  }
  __syncthreads();

  // The block's partials: its sub-tile accumulators summed in order.
  const int kd = k * d;
  for (int i = tid; i < kd; i += kThreads) {
    const int j = i / d, u = i % d;
    float s = 0.f;
    for (int g = 0; g < W::G; ++g) s += acc[(j * W::G + g) * DP + u];
    part_sums[(size_t)i * B + blockIdx.x] = s;
  }
  for (int j = tid; j < k; j += kThreads) {
    int c = 0;
    for (int w = 0; w < kWarps; ++w) c += cnt[w * k + j];
    part_counts[(size_t)j * B + blockIdx.x] = c;
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

// Lets the instance use all of a block's shared memory on `device`, once.
template <int DP, bool kFull>
int allow_smem(int device) {
  static std::atomic<uint64_t> done{0};
  const uint64_t bit = 1ull << device;
  if (done.load(std::memory_order_acquire) & bit) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      assign_partials_kernel<DP, kFull>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_acq_rel);
  return (int)e;
}

int64_t tile_count(int n) { return ((int64_t)n + kTile - 1) / kTile; }

template <int DP, bool kFull>
int launch(const float* points, const float* centroids, int32_t* ids,
           float* part_sums, int32_t* part_counts, int n, int d, int k,
           int tile, int blocks, int device, cudaStream_t stream) {
  const int64_t tiles = tile_count(n);
  const size_t smem = smem_floats<DP>(k) * sizeof(float);
  if (tile != kTile || smem > (size_t)kMaxSmem || blocks < 1 ||
      blocks > tiles || tiles > (int64_t)blocks * kMaxTilesPerBlock)
    return (int)cudaErrorInvalidValue;
  const int rc = allow_smem<DP, kFull>(device);
  if (rc != 0) return rc;
  assign_partials_kernel<DP, kFull><<<blocks, kThreads, smem, stream>>>(
      points, centroids, ids, part_sums, part_counts, n, d, k);
  return (int)cudaGetLastError();
}

template <int DP, bool kFull>
int occupancy(int k, int device, int* per_sm) {
  const int rc = allow_smem<DP, kFull>(device);
  if (rc != 0) return rc;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, assign_partials_kernel<DP, kFull>, kThreads,
      smem_floats<DP>(k) * sizeof(float));
}

// The (DP, kFull) instance for width d: d itself when it is 4, 8, 16 or 32
// (full rows, swizzled), else the next of those with a guarded scalar read.
#define KMEANS_DISPATCH(d, CALL) \
  ((d) == 4    ? CALL(4, true)   \
   : (d) < 4   ? CALL(4, false)  \
   : (d) == 8  ? CALL(8, true)   \
   : (d) < 8   ? CALL(8, false)  \
   : (d) == 16 ? CALL(16, true)  \
   : (d) < 16  ? CALL(16, false) \
   : (d) == 32 ? CALL(32, true)  \
               : CALL(32, false))

bool in_range(int n, int d, int k, int device) {
  return n > 0 && d > 0 && d <= kMaxD && k > 0 && k <= kMaxK &&
         device >= 0 && device < kMaxDevices;
}

}  // namespace

// points [n, d] f32, centroids [k, d] f32 -> ids [n] int32, sums [k, d] f32,
// counts [k] int32, through partials: (k*d + k) * blocks floats of scratch,
// the sums [k*d, blocks] f32 then the counts [k, blocks] int32. (tile,
// blocks) is kmeans.fused_plan(n, d, k, SMs) of the device `device` (the
// current one); any other plan returns cudaErrorInvalidValue. All
// contiguous. Launches both kernels on `stream`, allocates nothing and does
// not synchronise. Returns the first launch error's cudaError_t (0 on
// success).
extern "C" int kmeans_assign_partials(const void* points,
                                      const void* centroids, void* ids,
                                      void* partials, void* sums,
                                      void* counts, int n, int d, int k,
                                      int tile, int blocks, int device,
                                      void* stream) {
  if (!in_range(n, d, k, device)) return (int)cudaErrorInvalidValue;
  const float* p = static_cast<const float*>(points);
  const float* c = static_cast<const float*>(centroids);
  int32_t* o = static_cast<int32_t*>(ids);
  float* ps = static_cast<float*>(partials);
  int32_t* pc = reinterpret_cast<int32_t*>(ps + (size_t)k * d * blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(DP, FULL) \
  launch<DP, FULL>(p, c, o, ps, pc, n, d, k, tile, blocks, device, s)
  const int rc = KMEANS_DISPATCH(d, LAUNCH);
#undef LAUNCH
  if (rc != 0) return rc;
  reduce_partials_kernel<<<k * d + k, kThreads, 0, s>>>(
      ps, pc, static_cast<float*>(sums), static_cast<int32_t*>(counts),
      blocks, k * d);
  return (int)cudaGetLastError();
}

// Blocks of the instance for width d and k centroids that fit on an SM of
// device `device` (the current one): what a plan's blocks_per_sm is held
// against. Writes it to *per_sm and returns a cudaError_t (0 on success).
extern "C" int kmeans_assign_partials_occupancy(int d, int k, int device,
                                                int* per_sm) {
  if (!in_range(1, d, k, device)) return (int)cudaErrorInvalidValue;
#define OCCUPANCY(DP, FULL) occupancy<DP, FULL>(k, device, per_sm)
  return KMEANS_DISPATCH(d, OCCUPANCY);
#undef OCCUPANCY
}
