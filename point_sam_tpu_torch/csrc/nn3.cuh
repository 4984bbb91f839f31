// The exact 3-NN scan that K10 (interp.cu) and K1's second launch
// (fps_interp.cu; K9 runs K1's launch) share, and the squared distance with
// the reference's bits that every FPS, 3-NN and bin kernel computes.
//
// For every query, its 3 nearest keys: the keys in ascending order, each
// inserted into a running best-3 with strict <, so an equal distance never
// displaces an earlier key (ties to the smaller index: the order of the
// Pallas kernels' three masked min / argmin extractions and of K1's fused
// loop). The epilogue writes the indices and either the squared distances
// (K1: interp_idx, interp_d2) or the weights 1 / max(d^2, eps) normalised
// over the three (K10).
//
// What bounds it on the H100: about 9 instructions a (query, key) pair (3
// differences, a multiply and 2 FMAs, a min, the key's shared load and the
// batch's compare), 2.4 G lane instructions at 131072 queries x 2048 keys,
// some 0.08 ms at the card's issue rate; nothing of the N x G matrix leaves
// the SM. Design: a block of kNnThreads stages the keys in shared memory as
// float4, kNnTile at a time (32 KB, padded with keys at +inf to a whole
// batch), so a key is one broadcast LDS.128. A thread holds one query and
// takes the keys kNnBatch at a time into registers: their distances are
// independent, and one compare of their minimum with the third best skips
// the insertions of the whole batch (a batch without a key below the third
// best changes nothing), so the common path has no branch inside a batch.
// One query a thread keeps 31 warps an SM at the serve shape: holding 2 or 4
// queries a thread (one key load for several queries) left too few warps
// to hide the latency and measured slower on an H100, as did 8 keys a
// batch and two warps a query over halves of the keys.
//
// Bit-exactness: indices equal the JAX fps_xla / Pallas kernels' only if
// d^2 has the same bits. XLA compiles the reference's (dx^2 + dy^2) + dz^2
// into fma(dz, dz, fma(dx, dx, dy * dy)) (found by testing the candidates
// against the kernels in interpret mode on near-tied inputs); sq_dist writes
// exactly that with _rn intrinsics, which nvcc never re-associates or
// contracts differently.
#pragma once

#include <cuda_runtime.h>

namespace psam {

// d^2 of a point to a centre with the reference's bits (see above).
__device__ __forceinline__ float sq_dist(float x, float y, float z, float cx, float cy,
                                         float cz) {
  const float dx = __fsub_rn(x, cx);
  const float dy = __fsub_rn(y, cy);
  const float dz = __fsub_rn(z, cz);
  return __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
}

constexpr int kNnThreads = 128;
constexpr int kNnTile = 2048;  // keys a block stages at a time
constexpr int kNnBatch = 4;    // keys a thread takes into registers at a time

// Insert key g at distance d into the running best-3 (strict <: an equal
// distance stays behind the earlier key).
__device__ __forceinline__ void insert3(float d, int g, float& d0, float& d1, float& d2, int& i0,
                                        int& i1, int& i2) {
  if (d < d2) {
    if (d < d1) {
      d2 = d1;
      i2 = i1;
      if (d < d0) {
        d1 = d0;
        i1 = i0;
        d0 = d;
        i0 = g;
      } else {
        d1 = d;
        i1 = g;
      }
    } else {
      d2 = d;
      i2 = g;
    }
  }
}

// query [B, N, 3], key [B, G, 3]; idx_out [B, N, 3] int32 and out [B, N, 3]
// f32: d^2 (kWeights false) or the normalised weights (true). Thread t of
// block x holds query x * kNnThreads + t of row blockIdx.y.
template <bool kWeights>
__global__ void __launch_bounds__(kNnThreads)
nn3_kernel(const float* __restrict__ query, const float* __restrict__ key, int N, int G,
           float eps, int* __restrict__ idx_out, float* __restrict__ out) {
  __shared__ float4 sk[kNnTile];
  const int b = blockIdx.y, n = blockIdx.x * kNnThreads + threadIdx.x;
  const float* Kb = key + (size_t)b * G * 3;
  const float* q = query + ((size_t)b * N + min(n, N - 1)) * 3;
  const float qx = q[0], qy = q[1], qz = q[2];
  float d0 = INFINITY, d1 = INFINITY, d2 = INFINITY;
  int i0 = 0, i1 = 0, i2 = 0;
  for (int g0 = 0; g0 < G; g0 += kNnTile) {
    const int m = min(kNnTile, G - g0);
    const int mb = (m + kNnBatch - 1) / kNnBatch * kNnBatch;
    if (g0 > 0) __syncthreads();  // every thread is done with the last tile
    // Keys past G sit at +inf: their distance is +inf, never below d2.
    for (int i = threadIdx.x; i < mb; i += kNnThreads) {
      const float* c = Kb + (size_t)(g0 + i) * 3;
      sk[i] = i < m ? make_float4(c[0], c[1], c[2], 0.f)
                    : make_float4(INFINITY, INFINITY, INFINITY, 0.f);
    }
    __syncthreads();
    for (int i = 0; i < mb; i += kNnBatch) {
      float d[kNnBatch];
#pragma unroll
      for (int k = 0; k < kNnBatch; ++k) {
        const float4 c = sk[i + k];
        d[k] = sq_dist(qx, qy, qz, c.x, c.y, c.z);
      }
      float lo = d[0];
#pragma unroll
      for (int k = 1; k < kNnBatch; ++k) lo = fminf(lo, d[k]);
      if (lo < d2) {
#pragma unroll
        for (int k = 0; k < kNnBatch; ++k) insert3(d[k], g0 + i + k, d0, d1, d2, i0, i1, i2);
      }
    }
  }
  if (n >= N) return;
  const size_t o = ((size_t)b * N + n) * 3;
  idx_out[o] = i0;
  idx_out[o + 1] = i1;
  idx_out[o + 2] = i2;
  if (kWeights) {
    const float r0 = 1.0f / fmaxf(d0, eps), r1 = 1.0f / fmaxf(d1, eps), r2 = 1.0f / fmaxf(d2, eps);
    const float s = (r0 + r1) + r2;
    out[o] = r0 / s;
    out[o + 1] = r1 / s;
    out[o + 2] = r2 / s;
  } else {
    out[o] = d0;
    out[o + 1] = d1;
    out[o + 2] = d2;
  }
}

// The 3-NN of every query among the keys (see nn3_kernel).
template <bool kWeights>
int launch_nn3(const void* query, const void* key, int B, int N, int G, float eps,
               void* idx_out, void* out, void* stream) {
  if (B <= 0 || N <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kNnThreads - 1) / kNnThreads, B);
  nn3_kernel<kWeights><<<grid, kNnThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const float*>(key), N, G, eps,
      static_cast<int*>(idx_out), static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace psam
