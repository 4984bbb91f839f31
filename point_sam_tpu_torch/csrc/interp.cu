// K10: 3-NN interpolation weights, N query points against G keys.
//
// Replaces point_sam_tpu/ops/interp_pallas.py::interp_weights_pallas
// (_interp_kernel): for every query, its 3 nearest keys (ascending squared
// distance; among equal distances the smallest key index first, as the
// Pallas kernel's three masked min/argmin extractions give) and the
// weights 1 / max(d^2, eps), normalised over the three.
//
// What bounds it on the H100: the N x G distance matrix (1 GiB in fp32 at
// N=131072, G=2048) would make it bandwidth-bound if it touched device
// memory; kept in registers, the ~14 fp32 operations per (query, key) pair
// bound it (3.8 GFLOP at that shape).
// Design: every block stages all G keys in shared memory (G x 3 fp32, 24 KB
// at G=2048) as three coordinate arrays, so a warp reads one key as a
// broadcast; each thread owns one query and keeps a running best-3 in
// registers with strict <, scanning keys in ascending order, so an equal
// distance never displaces an earlier key. Nothing of the [N, G] matrix
// leaves the SM. G is bounded by shared memory (16384 keys = 192 KB).
//
// Bit-exactness: the Pallas kernel sums the explicit differences, and XLA
// compiles (dx^2 + dy^2) + dz^2 there into fma(dz, dz, fma(dx, dx, dy * dy))
// (the same contraction as FPS, found by testing the candidates against the
// kernel in interpret mode on near-tied inputs); the kernel writes exactly
// that with _rn intrinsics, so the indices equal the reference's.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxKeys = 16384;

__global__ void __launch_bounds__(kThreads)
interp_kernel(const float* __restrict__ query, const float* __restrict__ key, int N, int G,
              float eps, int* __restrict__ idx_out, float* __restrict__ w_out) {
  extern __shared__ float smem[];
  float* kx = smem;
  float* ky = kx + G;
  float* kz = ky + G;
  const int b = blockIdx.y;
  const float* K = key + (size_t)b * G * 3;
  for (int j = threadIdx.x; j < G; j += blockDim.x) {
    kx[j] = K[3 * j];
    ky[j] = K[3 * j + 1];
    kz[j] = K[3 * j + 2];
  }
  __syncthreads();

  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float* Q = query + ((size_t)b * N + n) * 3;
  const float qx = Q[0], qy = Q[1], qz = Q[2];
  float d0 = INFINITY, d1 = INFINITY, d2 = INFINITY;
  int i0 = 0, i1 = 0, i2 = 0;
  for (int j = 0; j < G; ++j) {
    const float dx = __fsub_rn(qx, kx[j]);
    const float dy = __fsub_rn(qy, ky[j]);
    const float dz = __fsub_rn(qz, kz[j]);
    const float d = __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
    if (d < d2) {
      if (d < d1) {
        d2 = d1;
        i2 = i1;
        if (d < d0) {
          d1 = d0;
          i1 = i0;
          d0 = d;
          i0 = j;
        } else {
          d1 = d;
          i1 = j;
        }
      } else {
        d2 = d;
        i2 = j;
      }
    }
  }
  const float r0 = 1.0f / fmaxf(d0, eps), r1 = 1.0f / fmaxf(d1, eps), r2 = 1.0f / fmaxf(d2, eps);
  const float s = (r0 + r1) + r2;
  const size_t o = ((size_t)b * N + n) * 3;
  idx_out[o] = i0;
  idx_out[o + 1] = i1;
  idx_out[o + 2] = i2;
  w_out[o] = r0 / s;
  w_out[o + 1] = r1 / s;
  w_out[o + 2] = r2 / s;
}

}  // namespace

// query [B, N, 3] f32, key [B, G, 3] f32 (3 <= G <= 16384); outputs
// idx [B, N, 3] int32 and weight [B, N, 3] f32.
extern "C" int psam_interp_weights(const void* query, const void* key, int B, int N, int G,
                                   float eps, void* idx_out, void* w_out, void* stream) {
  if (B <= 0 || N <= 0 || G < 3 || G > kMaxKeys) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)G * 3 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(interp_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + kThreads - 1) / kThreads, B);
  interp_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const float*>(key), N, G, eps,
      static_cast<int*>(idx_out), static_cast<float*>(w_out));
  return (int)cudaGetLastError();
}
