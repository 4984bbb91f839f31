// Shared helpers of the Hopper kernels in this directory.
//
// Every kernel takes its compute dtype T as a template parameter (float or
// __nv_bfloat16) and does its arithmetic in fp32 registers; values are
// rounded to T exactly where the JAX reference rounds (after a Dense, after
// LN -> GELU, ...), which is what ``round_to<T>`` expresses.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace psam {

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Round an fp32 value to the compute dtype and back.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

constexpr float kSqrtHalf = 0.7071067811865476f;
constexpr float kGeluC0 = 0.7978845608028654f;  // sqrt(2/pi)
constexpr float kGeluC1 = 0.044715f;

// Exact-erf GELU, x * 0.5 * (1 + erf(x / sqrt 2)) (torch nn.GELU default).
__device__ __forceinline__ float gelu_erf(float x) {
  return x * 0.5f * (1.0f + erff(x * kSqrtHalf));
}

// tanh-approximated GELU (torch nn.GELU(approximate='tanh')).
__device__ __forceinline__ float gelu_tanh(float x) {
  return 0.5f * x * (1.0f + tanhf(kGeluC0 * (x + kGeluC1 * x * x * x)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// out[r * ld_out + o] = sum_i in[r * ld_in + i] * W[i * n_out + o] for
// r < R, o < n_out, in fp32 (W is [n_in, n_out] row-major in dtype T, the
// flax ``kernel`` layout). ``in`` and ``out`` live in shared memory; each
// thread owns whole output columns, so no two threads write one element.
// The caller synchronises before and after.
template <typename T, int R>
__device__ __forceinline__ void rows_matmul(const float* __restrict__ in, int ld_in, int n_in,
                                            const T* __restrict__ W, int n_out,
                                            float* __restrict__ out, int ld_out) {
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    int i = 0;
    if ((ld_in & 3) == 0) {
      for (; i + 4 <= n_in; i += 4) {
        const float w0 = to_f32<T>(W[(size_t)(i + 0) * n_out + o]);
        const float w1 = to_f32<T>(W[(size_t)(i + 1) * n_out + o]);
        const float w2 = to_f32<T>(W[(size_t)(i + 2) * n_out + o]);
        const float w3 = to_f32<T>(W[(size_t)(i + 3) * n_out + o]);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 v = *reinterpret_cast<const float4*>(in + r * ld_in + i);
          acc[r] = fmaf(v.x, w0, acc[r]);
          acc[r] = fmaf(v.y, w1, acc[r]);
          acc[r] = fmaf(v.z, w2, acc[r]);
          acc[r] = fmaf(v.w, w3, acc[r]);
        }
      }
    }
    for (; i < n_in; ++i) {
      const float w = to_f32<T>(W[(size_t)i * n_out + o]);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(in[r * ld_in + i], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) out[r * ld_out + o] = acc[r];
  }
}

// GELU(y * scale + shift) rounded to T, for a normalised LN value y.
// ``tanh_act``: the affine in T and the tanh GELU on that value (the JAX
// kernel's act="tanh" operating point); otherwise the affine and the erf
// GELU stay in fp32.
template <typename T>
__device__ __forceinline__ float ln_gelu_value(float y, float scale, float shift, bool tanh_act) {
  if (tanh_act)
    return round_to<T>(gelu_tanh(
        round_to<T>(round_to<T>(round_to<T>(y) * round_to<T>(scale)) + round_to<T>(shift))));
  return round_to<T>(gelu_erf(y * scale + shift));
}

// Row epilogue of a Dense, optionally fused with LN -> GELU, one warp per
// row of width n <= 32 * kMaxPerLane, values held in registers:
//   v = round(round(x + add) + round(bias))   (flax Dense rounding; add and
//                                              bias may be null)
//   x = round(GELU(LN(v)))                     (when scale is not null)
// LN uses fp32 two-pass statistics with eps 1e-5; see ln_gelu_value.
// The result is written back to x and, when xbf is not null, in bf16 to
// xbf[r * ldbf + i] (the next matmul's tensor-core operand).
constexpr int kMaxPerLane = 16;

template <typename T>
__device__ __forceinline__ void rows_epilogue(float* __restrict__ x, int ld, int rows, int n,
                                              const float* __restrict__ add,
                                              const float* __restrict__ bias,
                                              const float* __restrict__ scale,
                                              const float* __restrict__ shift, bool tanh_act,
                                              __nv_bfloat16* __restrict__ xbf, int ldbf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += nwarps) {
    float* row = x + r * ld;
    float v[kMaxPerLane];
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      const int i = lane + 32 * j;
      v[j] = 0.0f;
      if (i < n) {
        const float a = round_to<T>(add ? row[i] + add[i] : row[i]);
        v[j] = bias ? round_to<T>(a + round_to<T>(bias[i])) : a;
        s += v[j];
      }
    }
    if (scale) {
      const float mean = warp_sum(s) / n;
      float q = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxPerLane; ++j) {
        const float c = v[j] - mean;
        if (lane + 32 * j < n) q += c * c;
      }
      const float inv = rsqrtf(warp_sum(q) / n + 1e-5f);
#pragma unroll
      for (int j = 0; j < kMaxPerLane; ++j) {
        const int i = lane + 32 * j;
        if (i >= n) continue;
        v[j] = ln_gelu_value<T>((v[j] - mean) * inv, scale[i], shift[i], tanh_act);
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxPerLane; ++j) {
      const int i = lane + 32 * j;
      if (i >= n) continue;
      row[i] = v[j];
      if (xbf) xbf[r * ldbf + i] = __float2bfloat16_rn(v[j]);
    }
  }
}

}  // namespace psam
