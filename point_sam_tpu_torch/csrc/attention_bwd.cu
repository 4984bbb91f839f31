// K6: backward of the dense multi-head attention K3, on [B, S, D] tensors.
//
// Replaces point_sam_tpu/ops/attention.py::mha_packed_bwd_pallas
// (_mha_packed_bwd_kernel). Per head, with the scale folded into q when it
// is a power of two (exact):
//   p  = softmax(q k^T * scale)            fp32, recomputed
//   dv = p^T do,  dp = do v^T              do and v taken to fp32
//   ds = p (dp - rowsum(dp p))             fp32 (times scale if not folded)
//   dq = ds (k scale),  dk = ds^T (q scale)   fp32 operands
// and dq, dk, dv are written in q's dtype.
//
// What bounds it on the H100: the Pallas kernel keeps a head's whole
// [S, S] probability and gradient matrices on chip; at the train shape
// (S=1024) that is 8 MB per head, far beyond a block's 227 KB of shared
// memory, and writing them to device memory would make the layer
// bandwidth-bound. So the [S, S] matrices exist only as 64 x 64 tiles,
// recomputed where they are needed, and the work is the S x S x dh
// products (5 are needed; this design runs 9 to avoid atomics).
// Design, after the FlashAttention-2 backward:
// - query pass, one block per (batch, head, 64-query tile): a first sweep
//   over the key tiles keeps the online softmax statistics of its rows
//   (running max m, sum l) and the running rowsum(e * dp), giving
//   D = rowsum(dp p); they go to an fp32 [B, H, S, 3] workspace. A second
//   sweep recomputes p and ds per key tile and accumulates dq;
// - key pass, one block per (batch, head, 64-key tile): reads the
//   statistics, sweeps the query tiles, recomputes p^T and ds^T per tile
//   and accumulates dk and dv.
// Each output element is owned by one thread of one block, so the grads
// are the same from run to run. All five products run as fp32 FMA loops in
// this first version (each thread owns 4 rows x 8 columns of a tile and
// 4 rows x dh/8 output columns, as K3's fp32 path); the two products with
// bf16-exact operands (q k^T, do v^T) could move to the tensor cores
// without changing a bit beyond summation order.
// Any S (ragged tiles are masked) and any dh <= 128 (zero-padded to 32,
// 64 or 128).
#include "common.cuh"

namespace {

constexpr int kTile = 64;  // query and key tile
constexpr int kThreads = 128;

// Load rows [r0, r0 + 64) of one head of a [B, S, D] tensor into an fp32
// tile [64][LD], zero past S and past dh; ``mul`` scales every value
// (the power-of-two softmax scale, exact).
template <typename T, int DHP>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, size_t base, int r0, int S,
                                          int D, int dh, float mul, float* dst) {
  constexpr int LD = DHP + 1;
  for (int e = threadIdx.x; e < kTile * DHP; e += kThreads) {
    const int r = e / DHP, c = e % DHP;
    float x = 0.0f;
    if (r0 + r < S && c < dh) x = psam::round_to<T>(psam::to_f32<T>(src[base + (size_t)(r0 + r) * D + c]) * mul);
    dst[r * LD + c] = x;
  }
}

// acc[i][j] = sum_d A[(rg + 16 i)][d] * Bm[(g + 8 j)][d] over DHP columns.
template <int DHP>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm, int rg, int g,
                                         float acc[4][8]) {
  constexpr int LD = DHP + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  for (int d = 0; d < DHP; ++d) {
    float a[4], b[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(rg + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = Bm[(g + 8 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// out[i][c] += sum_j P[(rg + 16 i)][j] * V[j][(g + 8 c)] over the 64 tile
// columns (P [64][kTile + 1], V [64][DHP + 1]).
template <int DHP>
__device__ __forceinline__ void tile_accum(const float* P, const float* V, int rg, int g,
                                           float out[4][DHP / 8]) {
  constexpr int LD = DHP + 1, LP = kTile + 1, OC = DHP / 8;
  for (int j = 0; j < kTile; ++j) {
    float pv[4], vv[OC];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = P[(rg + 16 * i) * LP + j];
#pragma unroll
    for (int c = 0; c < OC; ++c) vv[c] = V[j * LD + g + 8 * c];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < OC; ++c) out[i][c] = fmaf(pv[i], vv[c], out[i][c]);
  }
}

// The 8 threads of one row group are the lanes differing in bits 0-2.
__device__ __forceinline__ float group_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// Query pass: statistics (m, l, D) of 64 query rows, then dq.
template <typename T, int DHP>
__global__ void __launch_bounds__(kThreads)
attn_bwd_query_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ stats,
                      int S, int H, int dh, float scale, int fold) {
  using namespace psam;
  constexpr int LD = DHP + 1, LP = kTile + 1, OC = DHP / 8;
  extern __shared__ float sm[];
  float* Qs = sm;              // [64][LD], q * scale when the scale folds
  float* dOs = Qs + kTile * LD;
  float* Ks = dOs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;  // [64][LP]: ds of the current key tile

  const int D = H * dh;
  const int tid = threadIdx.x, g = tid & 7, rg = tid >> 3;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const size_t base = (size_t)b * S * D + (size_t)h * dh;
  load_tile<T, DHP>(q, base, q0, S, D, dh, fold ? scale : 1.0f, Qs);
  load_tile<T, DHP>(dout, base, q0, S, D, dh, 1.0f, dOs);

  float m[4], l[4], dsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
    dsum[i] = 0.0f;
  }
  float s[4][8], dp[4][8];
  // Sweep 1: online max / sum of e = exp(x - m) and of e * dp.
  for (int k0 = 0; k0 < S; k0 += kTile) {
    __syncthreads();
    load_tile<T, DHP>(k, base, k0, S, D, dh, 1.0f, Ks);
    load_tile<T, DHP>(v, base, k0, S, D, dh, 1.0f, Vs);
    __syncthreads();
    tile_dot<DHP>(Qs, Ks, rg, g, s);
    tile_dot<DHP>(dOs, Vs, rg, g, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float x = fold ? s[i][j] : s[i][j] * scale;
        if (k0 + g + 8 * j >= S) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float alpha = expf(m[i] - m_new);  // 0 on the first tile
      float se = 0.0f, sed = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float e = expf(s[i][j] - m_new);
        se += e;
        sed = fmaf(e, dp[i][j], sed);
      }
      l[i] = l[i] * alpha + group_sum(se);
      dsum[i] = dsum[i] * alpha + group_sum(sed);
      m[i] = m_new;
    }
  }
  float dd[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dd[i] = dsum[i] / l[i];
    const int r = q0 + rg + 16 * i;
    if (g == 0 && r < S) {
      float* st = stats + (((size_t)b * H + h) * S + r) * 3;
      st[0] = m[i];
      st[1] = l[i];
      st[2] = dd[i];
    }
  }

  // Sweep 2: p and ds per key tile, dq += ds k.
  float acc[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.0f;
  for (int k0 = 0; k0 < S; k0 += kTile) {
    __syncthreads();
    load_tile<T, DHP>(k, base, k0, S, D, dh, 1.0f, Ks);
    load_tile<T, DHP>(v, base, k0, S, D, dh, 1.0f, Vs);
    __syncthreads();
    tile_dot<DHP>(Qs, Ks, rg, g, s);
    tile_dot<DHP>(dOs, Vs, rg, g, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float x = fold ? s[i][j] : s[i][j] * scale;
        float ds = 0.0f;
        if (k0 + g + 8 * j < S) {
          const float p = expf(x - m[i]) / l[i];
          ds = p * (dp[i][j] - dd[i]);
          if (!fold) ds *= scale;
        }
        Ps[(rg + 16 * i) * LP + g + 8 * j] = ds;
      }
    __syncthreads();
    tile_accum<DHP>(Ps, Ks, rg, g, acc);
  }
  // Folded scale: ds (k scale) = (ds k) scale exactly (a power of two).
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + rg + 16 * i;
    if (r >= S) continue;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int col = g + 8 * c;
      if (col < dh) dq[base + (size_t)r * D + col] = from_f32<T>(fold ? acc[i][c] * scale : acc[i][c]);
    }
  }
}

// Key pass: dk and dv of 64 key rows from the query pass's statistics.
template <typename T, int DHP>
__global__ void __launch_bounds__(kThreads)
attn_bwd_key_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv,
                    const float* __restrict__ stats, int S, int H, int dh, float scale,
                    int fold) {
  using namespace psam;
  constexpr int LD = DHP + 1, LP = kTile + 1, OC = DHP / 8;
  extern __shared__ float sm[];
  float* Ks = sm;  // [64][LD]
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;   // q * scale when the scale folds
  float* dOs = Qs + kTile * LD;
  float* Pt = dOs + kTile * LD;  // [64 keys][LP] p^T
  float* dSt = Pt + kTile * LP;  // [64 keys][LP] ds^T
  float* st = dSt + kTile * LP;  // [64][3] (m, l, D) of the query tile

  const int D = H * dh;
  const int tid = threadIdx.x, g = tid & 7, rg = tid >> 3;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const size_t base = (size_t)b * S * D + (size_t)h * dh;
  load_tile<T, DHP>(k, base, k0, S, D, dh, 1.0f, Ks);
  load_tile<T, DHP>(v, base, k0, S, D, dh, 1.0f, Vs);

  float dka[4][OC], dva[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      dka[i][c] = 0.0f;
      dva[i][c] = 0.0f;
    }
  float s[4][8];
  for (int q0 = 0; q0 < S; q0 += kTile) {
    __syncthreads();
    load_tile<T, DHP>(q, base, q0, S, D, dh, fold ? scale : 1.0f, Qs);
    load_tile<T, DHP>(dout, base, q0, S, D, dh, 1.0f, dOs);
    for (int e = tid; e < kTile * 3; e += kThreads) {
      const int r = e / 3;
      st[e] = q0 + r < S ? stats[(((size_t)b * H + h) * S + q0) * 3 + e] : 0.0f;
    }
    __syncthreads();
    // p^T[key][query]
    tile_dot<DHP>(Ks, Qs, rg, g, s);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qi = g + 8 * j;
        float p = 0.0f;
        if (q0 + qi < S && k0 + rg + 16 * i < S) {
          const float x = fold ? s[i][j] : s[i][j] * scale;
          p = expf(x - st[qi * 3]) / st[qi * 3 + 1];
        }
        s[i][j] = p;
        Pt[(rg + 16 * i) * LP + qi] = p;
      }
    // dp^T[key][query] = v . do, then ds^T
    float dp[4][8];
    tile_dot<DHP>(Vs, dOs, rg, g, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qi = g + 8 * j;
        float ds = s[i][j] * (dp[i][j] - st[qi * 3 + 2]);
        if (!fold) ds *= scale;
        dSt[(rg + 16 * i) * LP + qi] = ds;
      }
    __syncthreads();
    tile_accum<DHP>(Pt, dOs, rg, g, dva);
    tile_accum<DHP>(dSt, Qs, rg, g, dka);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + rg + 16 * i;
    if (r >= S) continue;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int col = g + 8 * c;
      if (col >= dh) continue;
      dk[base + (size_t)r * D + col] = from_f32<T>(dka[i][c]);
      dv[base + (size_t)r * D + col] = from_f32<T>(dva[i][c]);
    }
  }
}

template <typename T, int DHP>
int launch(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
           void* dv, float* stats, int B, int S, int H, int dh, float scale, int fold,
           cudaStream_t stream) {
  constexpr int LD = DHP + 1, LP = kTile + 1;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  const size_t smem_q = (size_t)(4 * kTile * LD + kTile * LP) * sizeof(float);
  const size_t smem_k = (size_t)(4 * kTile * LD + 2 * kTile * LP + 3 * kTile) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_query_kernel<T, DHP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_key_kernel<T, DHP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_k);
  if (err != cudaSuccess) return (int)err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  attn_bwd_query_kernel<T, DHP><<<grid, kThreads, smem_q, stream>>>(
      qt, kt, vt, dot, static_cast<T*>(dq), stats, S, H, dh, scale, fold);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_key_kernel<T, DHP><<<grid, kThreads, smem_k, stream>>>(
      qt, kt, vt, dot, static_cast<T*>(dk), static_cast<T*>(dv), stats, S, H, dh, scale, fold);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
             void* dv, float* stats, int B, int S, int H, int dh, float scale, int fold,
             cudaStream_t st) {
  if (dh <= 32) return launch<T, 32>(q, k, v, dout, dq, dk, dv, stats, B, S, H, dh, scale, fold, st);
  if (dh <= 64) return launch<T, 64>(q, k, v, dout, dq, dk, dv, stats, B, S, H, dh, scale, fold, st);
  return launch<T, 128>(q, k, v, dout, dq, dk, dv, stats, B, S, H, dh, scale, fold, st);
}

}  // namespace

// q, k, v, dout and the outputs dq, dk, dv: [B, S, H * dh] contiguous, dtype
// float32 (dtype 0) or bfloat16 (dtype 1). stats: fp32 [B, H, S, 3]
// workspace. fold != 0: scale is a power of two, applied to q and k.
extern "C" int psam_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                  void* dq, void* dk, void* dv, void* stats, int B, int S, int H,
                                  int dh, float scale, int fold, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || dh <= 0 || dh > 128) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(stats);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, ws, B, S, H, dh, scale, fold, st);
  return dispatch<float>(q, k, v, dout, dq, dk, dv, ws, B, S, H, dh, scale, fold, st);
}
