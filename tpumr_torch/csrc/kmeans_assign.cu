// Nearest-centroid assignment for K-Means, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel tpumr/ops/kmeans.py::_assign_kernel (launched by
// pallas_assign). For every point x and every centroid c_j it computes, in f32,
//     d2_j = |x|^2 - 2 x.c_j + |c_j|^2
// (the same expression as the reference) and writes the index of the smallest
// d2_j as an int32 cluster id. Ties go to the lowest index, as jnp.argmin,
// np.argmin and torch.argmin do.
//
// Bound on this card: memory. At the main path's split shape (n = 4,000,000
// points, d = 16, k = 16) the kernel must read 256 MiB of points and write
// 16 MB of ids, about 285 MB, or 85 us at 3.35 TB/s. Its 2nkd = 2.1 GFLOP take
// about 32 us on the fp32 cores (67 TFLOP/s).
//
// Design, simple and right first:
// - No padding copy. The TPU kernel pads d to 128 lanes and k to 8 rows (8x
//   the bytes at d = 16); here each thread reads exactly its row and the last
//   block masks the ragged edge.
// - Each block stages the centroids and their squared norms in shared memory
//   once. The host side opts into more than 48 KB of dynamic shared memory
//   when k*d needs it (the wrapper caps k*d at 16384 floats).
// - One thread owns one point. It holds its row in registers when d <= 32
//   and scans the centroids in order with a strict '<'.
// Coalesced 16-byte loads, several points per thread and fusing the
// per-cluster partial sums into this kernel are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRegRow = 32;  // rows up to this width live in registers

template <bool kRowInRegs>
__global__ void __launch_bounds__(kThreads)
    kmeans_assign_kernel(const float* __restrict__ points,
                         const float* __restrict__ centroids,
                         int32_t* __restrict__ out, int n, int d, int k) {
  extern __shared__ float smem[];
  float* cent = smem;                   // [k, d]
  float* c2 = smem + (size_t)k * d;     // [k]
  const int kd = k * d;
  for (int i = threadIdx.x; i < kd; i += blockDim.x) cent[i] = centroids[i];
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    float s = 0.f;
    for (int t = 0; t < d; ++t) {
      const float v = cent[j * d + t];
      s += v * v;
    }
    c2[j] = s;
  }
  __syncthreads();

  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const float* row = points + p * d;

  float best = INFINITY;
  int best_j = 0;
  if (kRowInRegs) {
    float x[kRegRow];
    float x2 = 0.f;
#pragma unroll
    for (int t = 0; t < kRegRow; ++t) {
      x[t] = t < d ? row[t] : 0.f;
      x2 += x[t] * x[t];
    }
    for (int j = 0; j < k; ++j) {
      const float* c = cent + j * d;
      float dot = 0.f;
#pragma unroll
      for (int t = 0; t < kRegRow; ++t) {
        if (t < d) dot += x[t] * c[t];
      }
      const float d2 = x2 - 2.f * dot + c2[j];
      if (d2 < best) {
        best = d2;
        best_j = j;
      }
    }
  } else {
    float x2 = 0.f;
    for (int t = 0; t < d; ++t) {
      const float v = row[t];
      x2 += v * v;
    }
    for (int j = 0; j < k; ++j) {
      const float* c = cent + j * d;
      float dot = 0.f;
      for (int t = 0; t < d; ++t) dot += row[t] * c[t];
      const float d2 = x2 - 2.f * dot + c2[j];
      if (d2 < best) {
        best = d2;
        best_j = j;
      }
    }
  }
  out[p] = best_j;
}

template <bool kRowInRegs>
int launch(const float* points, const float* centroids, int32_t* out, int n,
           int d, int k, cudaStream_t stream) {
  const size_t smem = ((size_t)k * d + k) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kmeans_assign_kernel<kRowInRegs>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (int)(((int64_t)n + kThreads - 1) / kThreads);
  kmeans_assign_kernel<kRowInRegs>
      <<<blocks, kThreads, smem, stream>>>(points, centroids, out, n, d, k);
  return (int)cudaGetLastError();
}

}  // namespace

// points [n, d] f32, centroids [k, d] f32, out [n] int32: all contiguous, on
// the current device. Launches on `stream` and does not synchronise. Returns
// the launch's cudaError_t (0 on success).
extern "C" int kmeans_assign(const void* points, const void* centroids,
                             void* out, int n, int d, int k, void* stream) {
  if (n <= 0 || d <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const float* p = static_cast<const float*>(points);
  const float* c = static_cast<const float*>(centroids);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d <= kRegRow ? launch<true>(p, c, o, n, d, k, s)
                      : launch<false>(p, c, o, n, d, k, s);
}
