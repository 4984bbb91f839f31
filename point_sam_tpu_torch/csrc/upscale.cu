// K4: the mask decoder's per-point tail, fused with the 3-NN interpolation.
//
// Replaces point_sam_tpu/ops/upscale_pallas.py::interp_upscale_hyper_fused
// (_kernel_interp). Per point n of cloud b and mask replica m:
//   x = sum_k w[n, k] * h1[m][idx[n, k]]          (3-NN interp of G tokens)
//   h = GELU(Dense(GELU(LN(x))))                   (LN stats fp32, eps 1e-5)
//   logits[m, c, n] = <h, hyper[m, c]>             (fp32 accumulation)
// h1 is the Dense_0-projected token table [B*M, G, D] (the projection is
// hoisted to the G side by the caller). Duplicate neighbour indices add,
// as in the reference's weighted one-hot / gather-sum.
//
// What bounds it on the H100: the [B*M, N, D] interpolated and hidden
// tensors (0.13 GB each per replica at N=131072, D=256) would dominate as
// device-memory traffic; kept on chip, the D x D Dense (17 GFLOP per
// replica) and the gather of 3 token rows per point bound it.
// Design: one block per (32-point tile, replica) gathers the 3 rows of h1
// for each point directly by index (no one-hot matmul, no G cap), runs the
// tail on the tile in shared memory and writes [C, 32] fp32 logits.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
interp_upscale_kernel(const T* __restrict__ h1, const int* __restrict__ index,
                      const float* __restrict__ weight, const float* __restrict__ ln_s,
                      const float* __restrict__ ln_b, const T* __restrict__ w,
                      const float* __restrict__ bias, const T* __restrict__ hyper,
                      float* __restrict__ out, int M, int G, int N, int D, int C) {
  using namespace psam;
  extern __shared__ __align__(16) float smem[];
  const int ldx = D, ldh = D + 1;  // +1: the hyper dot reads hbuf by row
  float* xs = smem;                        // [kTile][ldx]
  float* hbuf = xs + kTile * ldx;          // [kTile][ldh]
  float* hyp = hbuf + kTile * ldh;         // [C][D]
  const int n0 = blockIdx.x * kTile, bm = blockIdx.y, b = bm / M;

  for (int e = threadIdx.x; e < C * D; e += blockDim.x)
    hyp[e] = to_f32<T>(hyper[(size_t)bm * C * D + e]);

  const T* table = h1 + (size_t)bm * G * D;
  for (int e = threadIdx.x; e < kTile * D; e += blockDim.x) {
    const int r = e / D, d = e % D, n = n0 + r;
    float x = 0.0f;
    if (n < N) {
      const size_t o = ((size_t)b * N + n) * 3;
      const int i0 = index[o], i1 = index[o + 1], i2 = index[o + 2];
      const float w0 = weight[o], w1 = weight[o + 1], w2 = weight[o + 2];
      // Weights of equal indices merge before the rounding to the compute
      // dtype, as the reference's summed one-hot rows do.
      const float m0 = round_to<T>(w0 + (i1 == i0 ? w1 : 0.0f) + (i2 == i0 ? w2 : 0.0f));
      const float m1 = i1 == i0 ? 0.0f : round_to<T>(w1 + (i2 == i1 ? w2 : 0.0f));
      const float m2 = (i2 == i0 || i2 == i1) ? 0.0f : round_to<T>(w2);
      x = m0 * to_f32<T>(table[(size_t)i0 * D + d]);
      x = fmaf(m1, to_f32<T>(table[(size_t)i1 * D + d]), x);
      x = fmaf(m2, to_f32<T>(table[(size_t)i2 * D + d]), x);
      x = round_to<T>(x);
    }
    xs[r * ldx + d] = x;
  }
  __syncthreads();
  rows_epilogue<T>(xs, ldx, kTile, D, nullptr, nullptr, ln_s, ln_b, false, nullptr, 0);
  __syncthreads();
  rows_matmul<T, kTile>(xs, ldx, D, w, D, hbuf, ldh);
  __syncthreads();
  for (int e = threadIdx.x; e < kTile * D; e += blockDim.x) {
    const int r = e / D, d = e % D;
    const float y = round_to<T>(round_to<T>(hbuf[r * ldh + d]) + round_to<T>(bias[d]));
    hbuf[r * ldh + d] = round_to<T>(gelu_erf(y));
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kTile * C; e += blockDim.x) {
    const int r = e % kTile, c = e / kTile, n = n0 + r;
    if (n >= N) continue;
    const float* hr = hbuf + r * ldh;
    const float* hc = hyp + c * D;
    float s = 0.0f;
    for (int d = 0; d < D; ++d) s = fmaf(hr[d], hc[d], s);
    out[((size_t)bm * C + c) * N + n] = s;
  }
}

template <typename T>
int launch(const void* h1, const void* index, const void* weight, const void* ln_s,
           const void* ln_b, const void* w, const void* b, const void* hyper, void* out,
           int B, int M, int G, int N, int D, int C, cudaStream_t stream) {
  const size_t smem = (size_t)(kTile * D + kTile * (D + 1) + C * D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(interp_upscale_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + kTile - 1) / kTile, B * M);
  interp_upscale_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(h1), static_cast<const int*>(index),
      static_cast<const float*>(weight), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<const T*>(w), static_cast<const float*>(b),
      static_cast<const T*>(hyper), static_cast<float*>(out), M, G, N, D, C);
  return (int)cudaGetLastError();
}

}  // namespace

// h1 [B*M, G, D], w [D, D] ([in, out]) and hyper [B*M, C, D] in the compute
// dtype (0 = float32, 1 = bfloat16); index [B, N, 3] int32 in [0, G);
// weight [B, N, 3], ln_s, ln_b, b [D] fp32; out [B*M, C, N] fp32; D <= 512.
extern "C" int psam_interp_upscale(const void* h1, const void* index, const void* weight,
                                   const void* ln_s, const void* ln_b, const void* w,
                                   const void* b, const void* hyper, void* out, int B, int M,
                                   int G, int N, int D, int C, int dtype, void* stream) {
  if (B <= 0 || M <= 0 || G <= 0 || N <= 0 || D <= 0 || C <= 0 ||
      D > 32 * psam::kMaxPerLane)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(h1, index, weight, ln_s, ln_b, w, b, hyper, out, B, M, G, N,
                                 D, C, st);
  return launch<float>(h1, index, weight, ln_s, ln_b, w, b, hyper, out, B, M, G, N, D, C, st);
}
