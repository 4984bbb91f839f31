// K6: backward of the dense multi-head attention K3, on [B, S, D] tensors.
//
// Replaces point_sam_tpu/ops/attention.py::mha_packed_bwd_pallas
// (_mha_packed_bwd_kernel). Per head, with x = q k^T * scale the logits:
//   p  = softmax(x)                    fp32, recomputed
//   dv = p^T do,  dp = do v^T
//   ds = p (dp - rowsum(dp p)) * scale
//   dq = ds k,  dk = ds^T q
// and dq, dk, dv are written in q's dtype.
//
// What bounds it on the H100: the five S x S x dh products the function
// needs (4.3 GFLOP each at the train shape [2, 1024, 1024], 16 heads of 64:
// 22 us at 989 TFLOP/s bf16) against 28 MB of inputs and outputs (9 us at
// 3.35 TB/s). The Pallas kernel keeps a head's whole [S, S] probability and
// gradient matrices on chip; at S=1024 that is 8 MB per head, far beyond a
// block's 227 KB of shared memory, and writing them to device memory would
// make the layer bandwidth-bound. So the [S, S] matrices exist only as
// tiles, recomputed where they are needed: the design runs 9 products where
// the function needs 5, and in exchange needs no atomics. After the
// FlashAttention-2 backward, two launches:
// - query pass, one block per (batch, head, 64-query tile): a first sweep
//   over the key tiles keeps the online softmax statistics of its rows
//   (running max m, sum l) and the running rowsum(e * dp), which give
//   D = rowsum(dp p); they go to an fp32 [B, H, S, 3] workspace. A second
//   sweep recomputes p and ds per key tile and accumulates dq;
// - key pass, one block per (batch, head, 64-key tile): reads the
//   statistics, sweeps the query tiles, recomputes p^T and ds^T per tile and
//   accumulates dk and dv.
// Each output element is owned by one thread of one block and summed in a
// fixed order, so the grads are the same from run to run.
//
// bf16 (attn_bwd_query_mma, attn_bwd_key_mma), K3's bf16 design
// (attention.cu) on mma.sync.m16n8k16 with fp32 accumulation (mma.cuh):
// - 4 warps a block, each owning 16 of the block's 64 rows (queries in the
//   query pass, keys in the key pass). The block's own pair of operands (Q
//   and dO; K and V) is loaded once into shared memory; the other pair
//   streams in 64-row tiles through a double buffer in shared memory,
//   filled by 16-byte cp.async.cg (rows past S zero-filled, the padding
//   columns dh..DHP zeroed once): the copy of tile t + 1 runs while tile t
//   is used. Rows are DHP + 8 elements apart, so each ldmatrix is free of
//   bank conflicts. At most 56 KB of shared memory a block (DHP 64: 36 KB
//   in the query pass, 55.5 KB in the key pass) and registers capped at 128
//   a thread up to DHP 64, so 4 blocks (16 warps) fit an SM and the
//   512-block train grid runs in one wave. At that cap ptxas spills a few
//   registers (PERF.md); a cap of 3 blocks an SM, without spills, measured
//   slower in the query pass.
// - Query pass: Q's and dO's A-fragments stay in registers (ldmatrix
//   once; Q and dO pass through the second stage before tile 1 arrives
//   there). S = Q K^T and dP = dO V^T in C fragments (K's and V's
//   B-fragments by ldmatrix). Sweep 1 keeps the running max and this lane's
//   parts of the two sums in registers (a row's 4 lanes reduce them once, at
//   the end). Sweep 2, 16 keys at a time: p and ds = p (dp - D) scale in
//   fp32 registers, ds packed to bf16 in place as the A-fragment of
//   dq += ds K (K's B-fragments by ldmatrix.trans).
// - Key pass: S^T = K Q^T and dP^T = V dO^T, K's and V's A-fragments read
//   by ldmatrix from their resident tiles at each use (the dk and dv
//   accumulators already take DHP registers a thread). Each thread reads
//   the statistics of its own fragment columns from the tile's copy in
//   shared memory (staged beside the tile by 4-byte cp.async). p^T and ds^T are
//   packed to bf16 A-fragments of dv += p^T dO and dk += ds^T Q, whose
//   B-fragments come by ldmatrix.trans from the tiles whose plain ldmatrix
//   fed S^T and dP^T.
// - The workspace holds (m * scale * log2 e, 1 / l, D) per row, so
//   p = exp2(x * scale * log2 e - m * scale * log2 e) / l is one FFMA, one
//   ex2.approx and one multiply, as in K3's forward. Queries past S read
//   zero statistics, so their p^T is exp2(0) * 0 = 0 with no extra mask.
// - Numerics: q k^T and do v^T have bf16 operands, so the tensor cores
//   change only their summation order. p and ds are rounded to bf16 for the
//   three other products, as FlashAttention-2 does and as K3 rounds e for
//   P V: one bf16 rounding (2^-9 relative) per operand against the plain
//   version's fp32 operands, inside the bf16 tolerance (2e-2 of the largest
//   plain grad; PERF.md records the worst share).
// fp32 (attn_bwd_query_kernel, attn_bwd_key_kernel): FMA loops over fp32
// shared-memory tiles; each thread owns 4 rows x 8 columns of a tile and 4
// rows x dh/8 output columns. When the scale is a power of two (exact) it
// is folded into q and k: dq = ds (k scale), dk = ds^T (q scale).
// Any S (ragged tiles are masked) and any dh <= 128 (zero-padded to 32,
// 64, 96 (bf16) or 128 columns: DHP).
#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kTile = 64;  // query and key tile
constexpr int kThreads = 128;

// ---- fp32: FMA loops over fp32 shared-memory tiles ----

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

// ---- bf16: mma.sync fragments in registers, cp.async tile pipeline ----

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

template <int DHP>
constexpr size_t smem_query_mma() {
  return (size_t)4 * kTile * (DHP + 8) * sizeof(bf16);
}

template <int DHP>
constexpr size_t smem_key_mma() {
  return (size_t)6 * kTile * (DHP + 8) * sizeof(bf16) +
         (size_t)2 * kTile * 3 * sizeof(float);
}

// Rows r0 .. r0 + 63 (r0 < S) of one head, row stride ld, columns < dh,
// into a [64][DHP + 8] tile; rows past S zero. vec: 16-byte cp.async (the
// caller commits), else element stores.
template <int DHP>
__device__ __forceinline__ void load_rows(const bf16* __restrict__ src, size_t base, int r0,
                                          int S, int ld, int dh, int vec, bf16* dst) {
  using namespace psam;
  constexpr int LDS = DHP + 8, CH = DHP / 8;
  if (vec) {
    for (int e = threadIdx.x; e < kTile * CH; e += kThreads) {
      const int r = e / CH, c = (e % CH) * 8;
      if (c >= dh) continue;
      const bool in = r0 + r < S;
      cp_async16(smem_u32(dst + r * LDS + c), src + base + (size_t)(in ? r0 + r : r0) * ld + c,
                 in);
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.0f);
    for (int e = threadIdx.x; e < kTile * dh; e += kThreads) {
      const int r = e / dh, c = e % dh;
      dst[r * LDS + c] = r0 + r < S ? src[base + (size_t)(r0 + r) * ld + c] : zero;
    }
  }
}

// Columns dh .. DHP of ``ntiles`` consecutive tiles, zero for the whole run.
template <int DHP>
__device__ __forceinline__ void zero_pad_columns(bf16* tiles, int ntiles, int dh) {
  const int w = DHP - dh;
  const bf16 zero = __float2bfloat16_rn(0.0f);
  for (int e = threadIdx.x; e < ntiles * kTile * w; e += kThreads)
    tiles[(e / w) * (DHP + 8) + dh + e % w] = zero;
}

// A warp's 16 x DHP fp32 C fragments (acc[n]: columns 8n .. 8n + 7) as bf16
// rows of a [16][DHP + 8] tile.
template <int DHP>
__device__ __forceinline__ void stage_rows(bf16* tile, const float (&acc)[DHP / 8][4], int lane) {
  const int g = lane >> 2, c0 = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < DHP / 8; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(tile + g * (DHP + 8) + 8 * n + c0) =
        __floats2bfloat162_rn(acc[n][0], acc[n][1]);
    *reinterpret_cast<__nv_bfloat162*>(tile + (g + 8) * (DHP + 8) + 8 * n + c0) =
        __floats2bfloat162_rn(acc[n][2], acc[n][3]);
  }
}

// The 16 rows of a [16][DHP + 8] tile to rows row0 .. of one head of dst
// (rows < S, columns < dh), by one warp.
template <int DHP>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, size_t base, int row0, int S,
                                           int ld, int dh, int vec, const bf16* tile, int lane) {
  constexpr int LDS = DHP + 8, CH = DHP / 8;
  if (vec) {
    for (int e = lane; e < 16 * CH; e += 32) {
      const int r = e / CH, c = (e % CH) * 8;
      if (row0 + r < S && c < dh)
        *reinterpret_cast<uint4*>(dst + base + (size_t)(row0 + r) * ld + c) =
            *reinterpret_cast<const uint4*>(tile + r * LDS + c);
    }
  } else {
    for (int e = lane; e < 16 * dh; e += 32) {
      const int r = e / dh, c = e % dh;
      if (row0 + r < S) dst[base + (size_t)(row0 + r) * ld + c] = tile[r * LDS + c];
    }
  }
}

// Query pass: the statistics (m, l, D) of 64 query rows, then dq.
// Shared memory: stage s holds key tile K at 2 s, V at 2 s + 1; Q and dO
// pass through stage 1. The two sweeps are one sequence of 2 * ntiles
// tiles (key tile t mod ntiles), so the copy of sweep 2's first tile
// overlaps sweep 1's last.
template <int DHP>
__global__ void __launch_bounds__(kThreads, DHP <= 64 ? 4 : DHP <= 96 ? 3 : 2)
attn_bwd_query_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   bf16* __restrict__ dq, float* __restrict__ stats, int S, int H, int dh,
                   float scale, int vec) {
  using namespace psam;
  static_assert(kTile == 16 * (kThreads / 32), "16 rows per warp");
  constexpr int LDS = DHP + 8, TILE = kTile * LDS;
  constexpr int KSTEPS = DHP / 16, NT = kTile / 8, OT = DHP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const sm = reinterpret_cast<bf16*>(smem_raw);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row group, column pair
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int ld = H * dh;
  const size_t base = (size_t)b * S * ld + (size_t)h * dh;
  const int ntiles = (S + kTile - 1) / kTile;
  const float sl = scale * kLog2e;

  zero_pad_columns<DHP>(sm, 4, dh);
  load_rows<DHP>(q, base, q0, S, ld, dh, vec, sm + 2 * TILE);
  load_rows<DHP>(dout, base, q0, S, ld, dh, vec, sm + 3 * TILE);
  load_rows<DHP>(k, base, 0, S, ld, dh, vec, sm);
  load_rows<DHP>(v, base, 0, S, ld, dh, vec, sm + TILE);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[KSTEPS][4], df[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const int off = (warp * 16 + (lane & 15)) * LDS + ks * 16 + (lane >> 4) * 8;
    ldmatrix_x4(qf[ks], smem_u32(sm + 2 * TILE + off));
    ldmatrix_x4(df[ks], smem_u32(sm + 3 * TILE + off));
  }

  // Tile t: wait for it, then issue the copy of tile t + 1 into the other
  // stage (at t = 0 the barrier also frees Q's and dO's stage).
  auto next_tile = [&](int t) -> const bf16* {
    cp_async_wait_all();
    __syncthreads();  // tile t visible; tile t - 1's stage free
    if (t + 1 < 2 * ntiles) {
      const int kn = (t + 1 < ntiles ? t + 1 : t + 1 - ntiles) * kTile;
      bf16* const next = sm + ((t + 1) & 1) * 2 * TILE;
      load_rows<DHP>(k, base, kn, S, ld, dh, vec, next);
      load_rows<DHP>(v, base, kn, S, ld, dh, vec, next + TILE);
      cp_async_commit();
    }
    return sm + (t & 1) * 2 * TILE;
  };
  // B-fragments of keys 16 jp .. 16 jp + 15 at k16 step ks, for X K^T / X V^T.
  auto kv_frag = [&](uint32_t (&r)[4], const bf16* X, int jp, int ks) {
    ldmatrix_x4(r, smem_u32(X + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS + ks * 16 +
                            ((lane >> 3) & 1) * 8));
  };

  // Sweep 1: the running max of rows g, g + 8 (unscaled logits) and this
  // lane's parts of their sums of e and of e * dp.
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.0f, 0.0f}, d_r[2] = {0.0f, 0.0f};
  for (int t = 0; t < ntiles; ++t) {
    const bf16* const Kt = next_tile(t);
    const bf16* const Vt = Kt + TILE;
    const int k0 = t * kTile;
    // S = Q K^T for the warp's 16 rows and the tile's 64 keys.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t bk[4];
        kv_frag(bk, Kt, jp, ks);
        mma_bf16(s[2 * jp], qf[ks], bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], qf[ks], bk[2], bk[3]);
      }
    if (k0 + kTile > S) {  // keys past S: -inf before the max
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (k0 + 8 * j + 2 * t4 + e >= S) s[j][e] = s[j][2 + e] = -INFINITY;
    }
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2], ms[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2_approx((m_r[i] - mx[i]) * sl);  // 0 on the first tile
      m_r[i] = mx[i];
      ms[i] = mx[i] * sl;
    }
    float es[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[j][i] = exp2_approx(fmaf(s[j][i], sl, -ms[i >> 1]));  // e
        es[i >> 1] += s[j][i];
      }
    // dP = dO V^T, 16 keys at a time, into the sum of e * dp.
    float ed[2] = {0.0f, 0.0f};
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      float dp[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t bv[4];
        kv_frag(bv, Vt, jp, ks);
        mma_bf16(dp[0], df[ks], bv[0], bv[1]);
        mma_bf16(dp[1], df[ks], bv[2], bv[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) ed[i >> 1] = fmaf(s[2 * jp + n][i], dp[n][i], ed[i >> 1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_r[i] = fmaf(l_r[i], alpha[i], es[i]);
      d_r[i] = fmaf(d_r[i], alpha[i], ed[i]);
    }
  }

  // The rows' statistics, to registers and the workspace.
  float m2[2], lsc[2], dd[2];  // m * sl, scale / l, D
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i], d = d_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    const float linv = 1.0f / l;
    m2[i] = m_r[i] * sl;
    dd[i] = d * linv;
    lsc[i] = linv * scale;
    const int r = q0 + warp * 16 + g + 8 * i;
    if (t4 == 0 && r < S) {
      float* st = stats + (((size_t)b * H + h) * S + r) * 3;
      st[0] = m2[i];
      st[1] = linv;
      st[2] = dd[i];
    }
  }

  // Sweep 2, 16 keys at a time: ds = p (dp - D) scale, then dq += ds K.
  float dqa[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dqa[n][i] = 0.0f;
  for (int t = ntiles; t < 2 * ntiles; ++t) {
    const bf16* const Kt = next_tile(t);
    const bf16* const Vt = Kt + TILE;
    const int k0 = (t - ntiles) * kTile;
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t bk[4], bv[4];
        kv_frag(bk, Kt, jp, ks);
        kv_frag(bv, Vt, jp, ks);
        mma_bf16(s[0], qf[ks], bk[0], bk[1]);
        mma_bf16(s[1], qf[ks], bk[2], bk[3]);
        mma_bf16(dp[0], df[ks], bv[0], bv[1]);
        mma_bf16(dp[1], df[ks], bv[2], bv[3]);
      }
      uint32_t da[4];  // ds as the A-fragment of this k16 step of ds K
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          x[i] = exp2_approx(fmaf(s[n][i], sl, -m2[i >> 1])) * lsc[i >> 1] *
                 (dp[n][i] - dd[i >> 1]);
        if (k0 + kTile > S) {  // keys past S: no gradient (their K rows are zero too)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (k0 + 16 * jp + 8 * n + 2 * t4 + e >= S) x[e] = x[2 + e] = 0.0f;
        }
        da[2 * n] = pack_bf16(x[0], x[1]);
        da[2 * n + 1] = pack_bf16(x[2], x[3]);
      }
#pragma unroll
      for (int c = 0; c < OT / 2; ++c) {
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, smem_u32(Kt + (jp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                                       c * 16 + (lane >> 4) * 8));
        mma_bf16(dqa[2 * c], da, bk[0], bk[1]);
        mma_bf16(dqa[2 * c + 1], da, bk[2], bk[3]);
      }
    }
  }

  // The last tile (2 ntiles - 1) is in stage 1: the warp's rows of stage 0
  // hold its dq rows for 16-byte stores.
  bf16* const Os = sm + warp * 16 * LDS;
  stage_rows<DHP>(Os, dqa, lane);
  __syncwarp();
  store_rows<DHP>(dq, base, q0 + warp * 16, S, ld, dh, vec, Os, lane);
}

// Key pass: dk and dv of 64 key rows from the query pass's statistics.
// Shared memory: stage s holds query tile Q at 2 s, dO at 2 s + 1, and the
// tile's 64 statistics triples after the bf16 tiles; K and V stay resident
// after the two stages.
template <int DHP>
__global__ void __launch_bounds__(kThreads, DHP <= 64 ? 4 : DHP <= 96 ? 3 : 2)
attn_bwd_key_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, const float* __restrict__ stats,
                 int S, int H, int dh, float scale, int vec) {
  using namespace psam;
  constexpr int LDS = DHP + 8, TILE = kTile * LDS;
  constexpr int KSTEPS = DHP / 16, NT = kTile / 8, OT = DHP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const sm = reinterpret_cast<bf16*>(smem_raw);
  bf16* const Ks = sm + 4 * TILE;
  bf16* const Vs = Ks + TILE;
  float* const sst = reinterpret_cast<float*>(sm + 6 * TILE);  // [2][64 * 3]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t4 = lane & 3;
  const int k0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int ld = H * dh;
  const size_t base = (size_t)b * S * ld + (size_t)h * dh;
  const float* const st_head = stats + ((size_t)b * H + h) * S * 3;
  const int ntiles = (S + kTile - 1) / kTile;
  const float sl = scale * kLog2e;

  // The statistics of query rows r0 .. r0 + 63, zero past S.
  auto load_stats = [&](int r0, float* dst) {
    for (int e = threadIdx.x; e < kTile * 3; e += kThreads) {
      const bool in = r0 + e / 3 < S;
      cp_async4(smem_u32(dst + e), st_head + (size_t)r0 * 3 + (in ? e : 0), in);
    }
  };

  zero_pad_columns<DHP>(sm, 6, dh);
  load_rows<DHP>(k, base, k0, S, ld, dh, vec, Ks);
  load_rows<DHP>(v, base, k0, S, ld, dh, vec, Vs);
  load_rows<DHP>(q, base, 0, S, ld, dh, vec, sm);
  load_rows<DHP>(dout, base, 0, S, ld, dh, vec, sm + TILE);
  load_stats(0, sst);
  cp_async_commit();

  // A-fragment of the warp's 16 key rows of X at k16 step ks.
  auto a_frag = [&](uint32_t (&r)[4], const bf16* X, int ks) {
    ldmatrix_x4(r, smem_u32(X + (warp * 16 + (lane & 15)) * LDS + ks * 16 + (lane >> 4) * 8));
  };
  float dka[OT][4], dva[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[n][i] = dva[n][i] = 0.0f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t visible; tile t - 1's stage free
    if (t + 1 < ntiles) {
      const int r0 = (t + 1) * kTile, s1 = (t + 1) & 1;
      load_rows<DHP>(q, base, r0, S, ld, dh, vec, sm + s1 * 2 * TILE);
      load_rows<DHP>(dout, base, r0, S, ld, dh, vec, sm + s1 * 2 * TILE + TILE);
      load_stats(r0, sst + s1 * kTile * 3);
      cp_async_commit();
    }
    const bf16* const Qt = sm + (t & 1) * 2 * TILE;
    const bf16* const Dt = Qt + TILE;
    const float* const st = sst + (t & 1) * kTile * 3;

#pragma unroll
    for (int jq = 0; jq < NT / 2; ++jq) {  // 16 queries at a time
      // S^T = K Q^T and dP^T = V dO^T (Q's and dO's B-fragments by ldmatrix).
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t kf[4], vf[4], bq[4], bd[4];
        a_frag(kf, Ks, ks);
        a_frag(vf, Vs, ks);
        const int row = jq * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int col = ks * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(bq, smem_u32(Qt + row * LDS + col));
        ldmatrix_x4(bd, smem_u32(Dt + row * LDS + col));
        mma_bf16(s[0], kf, bq[0], bq[1]);
        mma_bf16(s[1], kf, bq[2], bq[3]);
        mma_bf16(dp[0], vf, bd[0], bd[1]);
        mma_bf16(dp[1], vf, bd[2], bd[3]);
      }
      // p^T and ds^T as the A-fragments of this k16 step of p^T dO, ds^T Q.
      uint32_t pa[4], da[4];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float* sq = st + (jq * 16 + 8 * n + 2 * t4 + e) * 3;  // this column's query
          const float mq = sq[0], linv = sq[1], dq_row = sq[2];
#pragma unroll
          for (int i = e; i < 4; i += 2) {  // key rows g (i < 2) and g + 8
            p[i] = exp2_approx(fmaf(s[n][i], sl, -mq)) * linv;
            ds[i] = p[i] * scale * (dp[n][i] - dq_row);
          }
        }
        pa[2 * n] = pack_bf16(p[0], p[1]);
        pa[2 * n + 1] = pack_bf16(p[2], p[3]);
        da[2 * n] = pack_bf16(ds[0], ds[1]);
        da[2 * n + 1] = pack_bf16(ds[2], ds[3]);
      }
      // dv += p^T dO and dk += ds^T Q (B-fragments by ldmatrix.trans).
#pragma unroll
      for (int c = 0; c < OT / 2; ++c) {
        uint32_t bo[4], bq[4];
        const int off = (jq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + c * 16 +
                        (lane >> 4) * 8;
        ldmatrix_x4_trans(bo, smem_u32(Dt + off));
        ldmatrix_x4_trans(bq, smem_u32(Qt + off));
        mma_bf16(dva[2 * c], pa, bo[0], bo[1]);
        mma_bf16(dva[2 * c + 1], pa, bo[2], bo[3]);
        mma_bf16(dka[2 * c], da, bq[0], bq[1]);
        mma_bf16(dka[2 * c + 1], da, bq[2], bq[3]);
      }
    }
  }

  // dk and dv leave through the stage the last tile does not use.
  bf16* const Os = sm + (ntiles & 1) * 2 * TILE + warp * 16 * LDS;
  stage_rows<DHP>(Os, dka, lane);
  stage_rows<DHP>(Os + TILE, dva, lane);
  __syncwarp();
  store_rows<DHP>(dk, base, k0 + warp * 16, S, ld, dh, vec, Os, lane);
  store_rows<DHP>(dv, base, k0 + warp * 16, S, ld, dh, vec, Os + TILE, lane);
}

// The shared-memory limits are raised once per instantiation, at its first
// launch (the port runs on one device).
template <typename T, int DHP>
int launch(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
           void* dv, float* stats, int B, int S, int H, int dh, float scale, int fold,
           cudaStream_t stream) {
  constexpr int LD = DHP + 1, LP = kTile + 1;
  static constexpr size_t smem_q = (size_t)(4 * kTile * LD + kTile * LP) * sizeof(float);
  static constexpr size_t smem_k =
      (size_t)(4 * kTile * LD + 2 * kTile * LP + 3 * kTile) * sizeof(float);
  static const cudaError_t attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(attn_bwd_query_kernel<T, DHP>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem_q);
    return e != cudaSuccess ? e
                            : cudaFuncSetAttribute(attn_bwd_key_kernel<T, DHP>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   (int)smem_k);
  }();
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  attn_bwd_query_kernel<T, DHP><<<grid, kThreads, smem_q, stream>>>(
      qt, kt, vt, dot, static_cast<T*>(dq), stats, S, H, dh, scale, fold);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_key_kernel<T, DHP><<<grid, kThreads, smem_k, stream>>>(
      qt, kt, vt, dot, static_cast<T*>(dk), static_cast<T*>(dv), stats, S, H, dh, scale, fold);
  return (int)cudaGetLastError();
}

template <int DHP>
int launch_mma(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
               void* dv, float* stats, int B, int S, int H, int dh, float scale,
               cudaStream_t stream) {
  static constexpr size_t smem_q = smem_query_mma<DHP>(), smem_k = smem_key_mma<DHP>();
  static const cudaError_t attr = [] {
    const cudaError_t e = cudaFuncSetAttribute(attn_bwd_query_mma<DHP>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem_q);
    return e != cudaSuccess ? e
                            : cudaFuncSetAttribute(attn_bwd_key_mma<DHP>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   (int)smem_k);
  }();
  if (attr != cudaSuccess) return (int)attr;
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  // 16-byte rows: dh a multiple of 8 makes every row start (b S D + s D + h dh) one.
  const int vec = (dh & 7) == 0 && aligned(q) && aligned(k) && aligned(v) && aligned(dout) &&
                  aligned(dq) && aligned(dk) && aligned(dv);
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  attn_bwd_query_mma<DHP><<<grid, kThreads, smem_q, stream>>>(
      qt, kt, vt, dot, static_cast<bf16*>(dq), stats, S, H, dh, scale, vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_key_mma<DHP><<<grid, kThreads, smem_k, stream>>>(
      qt, kt, vt, dot, static_cast<bf16*>(dk), static_cast<bf16*>(dv), stats, S, H, dh, scale,
      vec);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, dout and the outputs dq, dk, dv: [B, S, H * dh] contiguous, dtype
// float32 (dtype 0) or bfloat16 (dtype 1). stats: fp32 [B, H, S, 3]
// workspace (fp32: (m, l, D); bf16: (m * scale * log2 e, 1 / l, D)).
// fold != 0: scale is a power of two, which the fp32 kernels apply to q and
// k (the bf16 kernels scale the logits and ds either way).
extern "C" int psam_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                  void* dq, void* dk, void* dv, void* stats, int B, int S, int H,
                                  int dh, float scale, int fold, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || dh <= 0 || dh > 128) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(stats);
  if (dtype == 1) {
    if (dh <= 32) return launch_mma<32>(q, k, v, dout, dq, dk, dv, ws, B, S, H, dh, scale, st);
    if (dh <= 64) return launch_mma<64>(q, k, v, dout, dq, dk, dv, ws, B, S, H, dh, scale, st);
    if (dh <= 96) return launch_mma<96>(q, k, v, dout, dq, dk, dv, ws, B, S, H, dh, scale, st);
    return launch_mma<128>(q, k, v, dout, dq, dk, dv, ws, B, S, H, dh, scale, st);
  }
  if (dh <= 32) return launch<float, 32>(q, k, v, dout, dq, dk, dv, ws, B, S, H, dh, scale, fold, st);
  if (dh <= 64) return launch<float, 64>(q, k, v, dout, dq, dk, dv, ws, B, S, H, dh, scale, fold, st);
  return launch<float, 128>(q, k, v, dout, dq, dk, dv, ws, B, S, H, dh, scale, fold, st);
}
