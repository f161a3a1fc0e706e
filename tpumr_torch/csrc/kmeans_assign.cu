// Nearest-centroid assignment for K-Means, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel tpumr/ops/kmeans.py::_assign_kernel (:57-63,
// launched by pallas_assign). For every point x and every centroid c_j it
// computes, in f32,
//     d2_j = |x|^2 - 2 x.c_j + |c_j|^2
// (the same expression as the reference, each dot product and norm taken in
// dimension order) and writes the index of the smallest d2_j as an int32
// cluster id. Ties go to the lowest index, as jnp.argmin, np.argmin and
// torch.argmin do. Any k >= 1 and d >= 1: centroids stream through shared
// memory in tiles, so nothing caps k * d.
//
// Bound on this card, from 2nkd f32 operations at 67 TFLOP/s against the
// bytes of the points read once and the ids written once at 3.35 TB/s:
// - operations at the second and third jobs' splits (500,000 x 40, k = 300:
//   12 GFLOP, 0.18 ms; 250,000 x 128, k = 1,024: 66 GFLOP, 0.98 ms), where
//   the [n, k] distances of the plain version are 0.6-1 GB a split;
// - bytes at the main path's split (4,000,000 x 16, k = 16: 272 MB, 81 us)
//   and at few centroids over wide rows (1,000,000 x 64, k = 10: 260 MB,
//   78 us).
//
// Design: a register-tiled distance "GEMM" with the argmin in its epilogue,
// so the [n, k] distances never reach device memory.
// - A block owns BM points and walks over the centroids [k_lo, k_hi) of its
//   part in tiles of BN, and over d in chunks of kBK floats. Each thread
//   holds TM x TN dot products in registers (points ty + TY*i, centroids
//   tx + TX*jj): every float4 of a centroid read from shared memory serves
//   TM points and every float4 of a point TN centroids. BN is one of
//   16, 32, 64 (BM = 256) or 128 (BM = 128), chosen by k so that k = 10 or
//   16 does not fill a 128-wide tile with padding, and k = 300 takes five
//   tiles of 64 rather than three of 128.
// - Rows sit in shared memory along d (a point's or centroid's floats
//   contiguous) with a row stride of an odd number of 16-byte units, so the
//   float4 reads of 8 consecutive rows by a quarter-warp hit distinct banks.
//   A warp is 4 point rows x 8 centroid rows.
// - Chunks arrive through a ring of kStages cp.async stages, so the next
//   chunks are in flight while this one is multiplied (16-byte copies where
//   d % 4 == 0 and the rows are 16-byte aligned, else 4-byte copies; zero
//   fill past n, k and d). Where the plan finds that BM * d floats fit, the
//   point tile stays resident across all centroid tiles: it is read from
//   device memory once, during the first tile. Else point chunks stream
//   through the ring with the centroid chunks. |x|^2 is accumulated, in
//   dimension order, as each point chunk of the first tile lands.
// - |c_j|^2 comes from a small pre-pass into a [k] scratch.
// - After each centroid tile, each thread forms d2 for its TM x TN pairs and
//   keeps a running best (d2, j) per point with a strict '<' in centroid
//   order. At the end the threads that share a point combine their bests by
//   the lexicographic (d2, j) minimum, which gives the id of a sequential
//   strict-'<' scan.
// - Split k: when the row blocks alone cannot fill the card, the centroid
//   tiles are cut into `splits` parts (blockIdx.y). Each part writes its best
//   (d2, j) per point into a [splits, n] scratch, and a second kernel picks
//   over the parts in order with a strict '<'. The host computes the plan
//   (BN, splits, resident) from n, d, k and the card's SM count alone
//   (tpumr_torch/ops/kmeans.py::assign_plan), so ids repeat bit for bit.
// - f32 FMAs on the CUDA cores: TF32 tensor cores keep about three decimal
//   digits and would move the ids away from the f32 reference.
// Tried on the card and not kept: rows stored dimension-major (4-byte copies
// scattered into [d][BM] tiles, one LDS.128 per 4 points or centroids of a
// dimension) was slower at every shape; chunks of 48 or 64 floats, or 16
// floats in 3 stages, were slower than 32 in 2; one block per SM with 255
// registers (no spill) was slower than two with 128 (a small spill).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 32;            // floats of d per chunk
constexpr int kBKP = kBK + 4;      // a chunk row's stride: 9 16-byte units
constexpr int kStages = 2;         // cp.async ring depth
constexpr int kMaxWX = 2;          // warps across the centroids of a tile

__host__ __device__ inline int round4(int d) { return (d + 3) & ~3; }

// Row stride of a resident point tile: d rounded up to 4 floats, then to an
// odd number of 16-byte units.
__host__ __device__ inline int resident_stride(int d) {
  const int s = round4(d);
  return (s / 4) % 2 ? s : s + 4;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies rows [0, rows) x floats [col0, col0 + kc) of a row-major [m, d]
// array, starting at row `row0`, into dst (row stride `stride`), with zeros
// past row m and past column d. kc is a multiple of 4; `vec` says that every
// row is 16-byte aligned and d % 4 == 0.
__device__ __forceinline__ void load_chunk(float* dst, int stride,
                                           const float* src, int64_t row0,
                                           int rows, int64_t m, int d,
                                           int col0, int kc, bool vec) {
  const int groups = kc / 4;
  for (int g = threadIdx.x; g < rows * groups; g += kThreads) {
    const int r = g / groups, q = 4 * (g % groups);
    const int64_t row = row0 + r;
    const int col = col0 + q;
    float* to = dst + r * stride + q;
    if (vec) {
      const bool valid = row < m && col < d;
      cp_async16(to, valid ? src + row * d + col : src, valid);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = row < m && col + e < d;
        cp_async4(to + e, valid ? src + row * d + col + e : src, valid);
      }
    }
  }
}

__device__ __forceinline__ bool before(float d2, int j, float best, int bj) {
  return d2 < best || (d2 == best && j < bj);
}

// Shared memory of one block, in floats: the centroid ring, the point tile
// (resident) or point ring (streamed), |x|^2, and the cross-warp bests.
template <int BM, int BN>
size_t smem_floats(int d, bool resident) {
  return (size_t)kStages * BN * kBKP +
         (resident ? (size_t)BM * resident_stride(d)
                   : (size_t)kStages * BM * kBKP) +
         (1 + 2 * kMaxWX) * (size_t)BM;
}

// One float4 step (dims u .. u + 3 of the chunk) of the TM x TN dot
// products: each product takes its dims in order.
template <int TM, int TN, int TX, int TY>
__device__ __forceinline__ void fma_step(float (&acc)[TM][TN],
                                         const float* cs, const float* xs,
                                         int xstride, int tx, int ty,
                                         int u) {
  float4 cv[TN];
#pragma unroll
  for (int jj = 0; jj < TN; ++jj)
    cv[jj] = *reinterpret_cast<const float4*>(cs + (tx + TX * jj) * kBKP + u);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const float4 xv =
        *reinterpret_cast<const float4*>(xs + (ty + TY * i) * xstride + u);
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) {
      acc[i][jj] = fmaf(xv.x, cv[jj].x, acc[i][jj]);
      acc[i][jj] = fmaf(xv.y, cv[jj].y, acc[i][jj]);
      acc[i][jj] = fmaf(xv.z, cv[jj].z, acc[i][jj]);
      acc[i][jj] = fmaf(xv.w, cv[jj].w, acc[i][jj]);
    }
  }
}

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads, 2)
    assign_tiles_kernel(const float* __restrict__ points,
                        const float* __restrict__ centroids,
                        const float* __restrict__ c2,
                        float* __restrict__ part_d2,
                        int32_t* __restrict__ part_j,
                        int32_t* __restrict__ ids, int n, int d, int k,
                        int splits, bool resident, bool vec_p, bool vec_c) {
  constexpr int TX = BN / TN;   // threads across the centroids of a tile
  constexpr int TY = BM / TM;   // threads across the points of the block
  constexpr int WX = TX / 8;    // warps across the centroids
  static_assert(TX * TY == kThreads && TX % 8 == 0 && WX <= kMaxWX,
                "bad tile instance");

  extern __shared__ float4 smem4[];
  float* cring = reinterpret_cast<float*>(smem4);      // [kStages][BN][kBKP]
  float* xbuf = cring + kStages * BN * kBKP;           // resident or ring
  const int sdp = resident_stride(d);
  float* x2s = xbuf + (resident ? BM * sdp : kStages * BM * kBKP);  // [BM]
  float* red_d2 = x2s + BM;                                      // [WX][BM]
  int* red_j = reinterpret_cast<int*>(red_d2 + WX * BM);         // [WX][BM]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = (warp % WX) * 8 + (lane & 7);
  const int ty = (warp / WX) * 4 + (lane >> 3);
  const int64_t row0 = (int64_t)blockIdx.x * BM;

  // this block's part of the centroid tiles, as assign_plan cuts them
  const int tiles = (k + BN - 1) / BN;
  const int part = blockIdx.y;
  const int tile_lo = (int)((int64_t)part * tiles / splits);
  const int tile_hi = (int)((int64_t)(part + 1) * tiles / splits);
  const int k_hi = min(tile_hi * BN, k);

  const int d4 = round4(d);
  const int chunks = (d4 + kBK - 1) / kBK;
  const int steps = (tile_hi - tile_lo) * chunks;

  // Step s loads chunk s % chunks of centroid tile s / chunks, and of the
  // points too unless they are resident and already loaded.
  auto issue = [&](int s) {
    const int t = s / chunks, c = s % chunks, col0 = c * kBK;
    const int kc = min(kBK, d4 - col0), slot = s % kStages;
    load_chunk(cring + slot * BN * kBKP, kBKP, centroids,
               (int64_t)(tile_lo + t) * BN, BN, k, d, col0, kc, vec_c);
    if (!resident)
      load_chunk(xbuf + slot * BM * kBKP, kBKP, points, row0, BM, n, d, col0,
                 kc, vec_p);
    else if (t == 0)
      load_chunk(xbuf + col0, sdp, points, row0, BM, n, d, col0, kc, vec_p);
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }
  for (int p = tid; p < BM; p += kThreads) x2s[p] = 0.f;

  float acc[TM][TN], best[TM];
  int bj[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best[i] = INFINITY;
    bj[i] = 0;
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) acc[i][jj] = 0.f;
  }

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kStages - 2>();   // step s's chunks have landed ...
    __syncthreads();                // ... for every thread; step s-1 is done
    if (s + kStages - 1 < steps) issue(s + kStages - 1);
    cp_async_commit();

    const int t = s / chunks, c = s % chunks, col0 = c * kBK;
    const int kc = min(kBK, d4 - col0), slot = s % kStages;
    const float* cs = cring + slot * BN * kBKP;
    const float* xs = resident ? xbuf + col0 : xbuf + slot * BM * kBKP;
    const int xstride = resident ? sdp : kBKP;

    if (t == 0) {   // |x|^2, one chunk at a time in dimension order
      for (int p = tid; p < BM; p += kThreads) {
        float v = x2s[p];
        for (int u = 0; u < kc; u += 4) {
          const float4 x = *reinterpret_cast<const float4*>(
              xs + p * xstride + u);
          v = fmaf(x.x, x.x, v);
          v = fmaf(x.y, x.y, v);
          v = fmaf(x.z, x.z, v);
          v = fmaf(x.w, x.w, v);
        }
        x2s[p] = v;
      }
    }

    if (kc == kBK) {
#pragma unroll
      for (int u = 0; u < kBK; u += 4)
        fma_step<TM, TN, TX, TY>(acc, cs, xs, xstride, tx, ty, u);
    } else {
      for (int u = 0; u < kc; u += 4)
        fma_step<TM, TN, TX, TY>(acc, cs, xs, xstride, tx, ty, u);
    }

    if (c == chunks - 1) {   // the tile's dot products are complete
      if (t == 0) __syncthreads();   // and so is every |x|^2
      const int jb = (tile_lo + t) * BN;
      float x2[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) x2[i] = x2s[ty + TY * i];
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) {
        const int j = jb + tx + TX * jj;
        const float cj = j < k_hi ? c2[j] : 0.f;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float dist = x2[i] - 2.f * acc[i][jj] + cj;
          if (j < k_hi && dist < best[i]) {
            best[i] = dist;
            bj[i] = j;
          }
          acc[i][jj] = 0.f;
        }
      }
    }
  }

  // Combine the bests of the threads that share a point: the 8 lanes of a
  // row of the warp, then the WX warps across the centroids.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float b = best[i];
    int j = bj[i];
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, b, off);
      const int oj = __shfl_xor_sync(0xffffffffu, j, off);
      if (before(ob, oj, b, j)) {
        b = ob;
        j = oj;
      }
    }
    if ((lane & 7) == 0) {
      red_d2[(warp % WX) * BM + ty + TY * i] = b;
      red_j[(warp % WX) * BM + ty + TY * i] = j;
    }
  }
  __syncthreads();
  for (int p = tid; p < BM; p += kThreads) {
    float b = red_d2[p];
    int j = red_j[p];
#pragma unroll
    for (int w = 1; w < WX; ++w) {
      if (before(red_d2[w * BM + p], red_j[w * BM + p], b, j)) {
        b = red_d2[w * BM + p];
        j = red_j[w * BM + p];
      }
    }
    const int64_t row = row0 + p;
    if (row < n) {
      if (splits == 1) {
        ids[row] = j;
      } else {
        part_d2[(int64_t)part * n + row] = b;
        part_j[(int64_t)part * n + row] = j;
      }
    }
  }
}

// |row|^2 of each of m rows of width d, in dimension order.
__global__ void row_norms_kernel(const float* __restrict__ rows, int m, int d,
                                 float* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= m) return;
  const float* row = rows + (int64_t)r * d;
  float s = 0.f;
  for (int t = 0; t < d; ++t) s = fmaf(row[t], row[t], s);
  out[r] = s;
}

// The id of each point over the parts of split k, in part order with a
// strict '<': the lowest index among the smallest distances.
__global__ void pick_parts_kernel(const float* __restrict__ part_d2,
                                  const int32_t* __restrict__ part_j,
                                  int32_t* __restrict__ ids, int n,
                                  int splits) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  float best = INFINITY;
  int bj = 0;
  for (int s = 0; s < splits; ++s) {
    const float v = part_d2[(int64_t)s * n + p];
    if (v < best) {
      best = v;
      bj = part_j[(int64_t)s * n + p];
    }
  }
  ids[p] = bj;
}

template <int BM, int BN, int TM, int TN>
int launch(const float* points, const float* centroids, const float* c2,
           float* part_d2, int32_t* part_j, int32_t* ids, int n, int d, int k,
           int splits, bool resident, cudaStream_t stream) {
  if (splits < 1 || splits > (k + BN - 1) / BN || splits > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats<BM, BN>(d, resident) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      assign_tiles_kernel<BM, BN, TM, TN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const bool vec_p =
      d % 4 == 0 && (reinterpret_cast<uintptr_t>(points) & 15) == 0;
  const bool vec_c =
      d % 4 == 0 && (reinterpret_cast<uintptr_t>(centroids) & 15) == 0;
  const dim3 grid((unsigned)(((int64_t)n + BM - 1) / BM), (unsigned)splits);
  assign_tiles_kernel<BM, BN, TM, TN><<<grid, kThreads, smem, stream>>>(
      points, centroids, c2, part_d2, part_j, ids, n, d, k, splits, resident,
      vec_p, vec_c);
  return (int)cudaGetLastError();
}

}  // namespace

// points [n, d] f32, centroids [k, d] f32 -> out [n] int32, through the
// scratch c2 [k] f32 and, when splits > 1, part_d2 [splits, n] f32 and
// part_j [splits, n] int32 (else they may be null). bn (16, 32, 64 or 128),
// splits and resident are the plan of tpumr_torch/ops/kmeans.py::assign_plan.
// All contiguous, on the current device. Launches on `stream`, allocates
// nothing and does not synchronise. Returns the first launch error's
// cudaError_t (0 on success).
extern "C" int kmeans_assign(const void* points, const void* centroids,
                             void* c2, void* part_d2, void* part_j, void* out,
                             int n, int d, int k, int bn, int splits,
                             int resident, void* stream) {
  if (n <= 0 || d <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  if (splits > 1 && (part_d2 == nullptr || part_j == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* p = static_cast<const float*>(points);
  const float* c = static_cast<const float*>(centroids);
  float* c2f = static_cast<float*>(c2);
  float* pd = static_cast<float*>(part_d2);
  int32_t* pj = static_cast<int32_t*>(part_j);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  row_norms_kernel<<<(k + 255) / 256, 256, 0, s>>>(c, k, d, c2f);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const bool res = resident != 0;
  int rc;
  switch (bn) {
    case 16:
      rc = launch<256, 16, 8, 2>(p, c, c2f, pd, pj, o, n, d, k, splits, res, s);
      break;
    case 32:
      rc = launch<256, 32, 8, 4>(p, c, c2f, pd, pj, o, n, d, k, splits, res, s);
      break;
    case 64:
      rc = launch<256, 64, 8, 8>(p, c, c2f, pd, pj, o, n, d, k, splits, res, s);
      break;
    case 128:
      rc = launch<128, 128, 8, 8>(p, c, c2f, pd, pj, o, n, d, k, splits, res,
                                  s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (rc != 0 || splits == 1) return rc;
  pick_parts_kernel<<<(unsigned)(((int64_t)n + 255) / 256), 256, 0, s>>>(
      pd, pj, o, n, splits);
  return (int)cudaGetLastError();
}
