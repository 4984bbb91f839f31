// K4: the mask decoder's per-point tail, fused with the 3-NN interpolation,
// and K11: the same tail on rows that were interpolated beforehand.
//
// K4 replaces point_sam_tpu/ops/upscale_pallas.py::interp_upscale_hyper_fused
// (_kernel_interp). Per point n of cloud b and mask replica m:
//   x = sum_k w[n, k] * h1[m][idx[n, k]]          (3-NN interp of G tokens)
//   h = GELU(Dense(GELU(LN(x))))                   (LN stats fp32, eps 1e-5)
//   logits[m, c, n] = <h, hyper[m, c]>             (fp32 accumulation)
// h1 is the Dense_0-projected token table [B*M, G, D] (the projection is
// hoisted to the G side by the caller). Duplicate neighbour indices add,
// as in the reference's weighted one-hot / gather-sum.
// K11 replaces upscale_hyper_fused (_kernel): the decoder takes it where
// K4's gate fails (G > 2048, G % 128 != 0, or K4's working set too large),
// after a plain 3-NN gather; x is then the row n of x [B*M, N, D] itself.
// The Pallas kernel writes [BM, N, C] and transposes; K11 writes [BM, C, N].
//
// What bounds it on the H100: the [B*M, N, D] interpolated and hidden
// tensors (0.13 GB each per replica at N=131072, D=256) would dominate as
// device-memory traffic; kept on chip, the D x D Dense (17 GFLOP per
// replica at N=131072, D=256) and the gather of 3 token rows a point from
// L2 (the table is 0.5-1 MB) bound K4. K11 reads the [B*M, N, D] rows once
// (34 MB at N=131072, D=128 in bf16), which bounds it.
//
// Two routes, chosen by the caller from the shapes alone
// (ops/upscale_pallas.py::upscale_route); neither falls back to the other.
// - "mma" (bf16, D = 128 or 256, the widths of every model's tail, C <= 8):
//   interp_upscale_mma_kernel<D, kGather>, one persistent block an SM of
//   two groups of 8 warps. W [D, D] is copied into shared memory once a
//   block (cp.async, rows padded by 8 elements as mma_tile.cuh lays them
//   out) and shared by both groups; each group walks its own (64-row tile,
//   replica) items with its own named barrier, so one group's gather
//   overlaps the other's products. Per tile:
//   1. a warp per row: each lane loads its D/32 columns of the row (K11) or
//      of the three neighbour rows of h1[bm] (K4; the row's index and
//      weights were loaded for the warp's 8 rows at once and merged for
//      equal indices), interpolates in fp32, rounds x to bf16, takes LN's
//      two-pass fp32 statistics by warp_sum and the erf GELU, and stores the
//      bf16 row of the A tile 16 bytes a lane (8 at D = 128). Rows past N
//      are zero (LN of a zero row is finite) and never stored;
//   2. the Dense on mma.sync (mma_smem, A and W in shared memory, fp32
//      accumulators): warp (rg, cg) owns rows 32 rg.. by columns (D/4) cg..;
//      the epilogue rounds as flax does, round(round(acc) + round(b)), then
//      GELU, rounded to bf16, into the H tile (over the A tile);
//   3. the hypernet dot on mma.sync (mma_smem_nt, hyper [C <= 8 zero-padded
//      to 16][D] as the [n][k] operand, loaded when the replica changes):
//      warp (kh, mt) sums row tile mt over half kh of D; the two halves meet
//      in a [16][68] fp32 staging tile over H, and the first C rows go to
//      out[bm, c, n0 : n0 + 64] coalesced along n.
//   Shared memory at D = 256: W 132 KB, LN and bias vectors 3 KB, per group
//   the A / H tile 33 KB and the hyper rows 8.25 KB: 217.5 KB, so one block
//   (16 warps, <= 128 registers a thread) an SM.
// - "fma" (fp32, and bf16 at other widths): interp_upscale_kernel<T,
//   kGather>, one block per (32-point tile, replica), the tail in fp32
//   shared-memory tiles and the Dense on FMA units (rows_matmul). It is the
//   route the fp32 Predictors and train step take on the card.
#include <algorithm>

#include "common.cuh"
#include "mma_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ fma route
constexpr int kThreads = 128;
constexpr int kTile = 32;

// kGather: K4 (x gathered from h1 by index / weight); otherwise K11 (h1 is
// x [B*M, N, D] and index / weight are unused).
template <typename T, bool kGather>
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
    if (n < N && !kGather) {
      x = to_f32<T>(h1[((size_t)bm * N + n) * D + d]);
    } else if (n < N) {
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

// ------------------------------------------------------------ mma route
constexpr int kRows = 64;                         // rows of a tile
constexpr int kGroupWarps = 8;                    // warps of a group: one tile in flight
constexpr int kGroups = 2;                        // groups of a block, sharing W
constexpr int kGroupThreads = 32 * kGroupWarps;
constexpr int kMmaThreads = kGroups * kGroupThreads;
constexpr int kRowsPerWarp = kRows / kGroupWarps;  // 8
constexpr int kMaxC = 8;                          // hyper rows, zero-padded to one n16 pair
constexpr int kHypRows = 16;
constexpr int kStageLd = kRows + 4;               // fp32 logits staging row (bank padding)

// Shared-memory layout of interp_upscale_mma_kernel<D> in bytes: W [D][ld]
// bf16, then ln_s, ln_b, bias [3][D] fp32, then each group's A / H tile
// [kRows][ld] bf16 and hyper rows [kHypRows][ld] bf16. The fp32 logits
// staging [2][kHypRows][kStageLd] lies over the group's H tile.
template <int D>
struct MmaLayout {
  static constexpr int ld = D + 8;
  static constexpr int w_bytes = D * ld * 2;
  static constexpr int vec_bytes = 3 * D * 4;
  static constexpr int tile_bytes = kRows * ld * 2;
  static constexpr int hyp_bytes = kHypRows * ld * 2;
  static constexpr int group_bytes = tile_bytes + hyp_bytes;
  static constexpr int total = w_bytes + vec_bytes + kGroups * group_bytes;
  static_assert(2 * kHypRows * kStageLd * 4 <= tile_bytes, "the staging exceeds the H tile");
  static_assert(total <= 232448, "beyond the H100's 227 KB of shared memory a block");
};

__device__ __forceinline__ float lo_f32(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_f32(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// V consecutive bf16 of global memory as V / 2 bf16x2 words, in 16- or
// 8-byte loads as V allows (p is aligned to 2 V bytes).
template <int V>
__device__ __forceinline__ void load_bf16(uint32_t (&r)[V / 2], const bf16* p) {
  static_assert(V % 4 == 0, "a lane's columns are 8 or 16 bytes");
  if constexpr (V % 8 == 0) {
#pragma unroll
    for (int q = 0; q < V / 8; ++q) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[q];
      r[4 * q] = u.x, r[4 * q + 1] = u.y, r[4 * q + 2] = u.z, r[4 * q + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const uint2 u = reinterpret_cast<const uint2*>(p)[q];
      r[2 * q] = u.x, r[2 * q + 1] = u.y;
    }
  }
}

// The same, stored to shared memory.
template <int V>
__device__ __forceinline__ void store_bf16(bf16* p, const uint32_t (&r)[V / 2]) {
  static_assert(V % 4 == 0, "a lane's columns are 8 or 16 bytes");
  if constexpr (V % 8 == 0) {
#pragma unroll
    for (int q = 0; q < V / 8; ++q)
      reinterpret_cast<uint4*>(p)[q] = make_uint4(r[4 * q], r[4 * q + 1], r[4 * q + 2],
                                                  r[4 * q + 3]);
  } else {
#pragma unroll
    for (int q = 0; q < V / 4; ++q)
      reinterpret_cast<uint2*>(p)[q] = make_uint2(r[2 * q], r[2 * q + 1]);
  }
}

// The barrier of one group's 8 warps (ids 1, 2; 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "n"(kGroupThreads) : "memory");
}

// Step 1 of a tile: rows n0.. of replica bm -> x (gathered for K4) -> LN ->
// GELU -> bf16 rows of the A tile xs. Warp wg of the group takes rows wg,
// wg + 8, ...; lane l columns [l V, l V + V). vs holds ln_s, ln_b.
template <int D, bool kGather>
__device__ __forceinline__ void tile_rows(bf16* __restrict__ xs, const float* __restrict__ vs,
                                          const bf16* __restrict__ h1,
                                          const int* __restrict__ index,
                                          const float* __restrict__ weight, int bm, int b, int G,
                                          int N, int n0, int wg, int lane) {
  using namespace psam;
  constexpr int ld = D + 8, V = D / 32;
  // Rows whose loads are in flight together: all 8 but K4's 3 x 16-byte
  // rows at D > 128, 4 at a time there (registers).
  constexpr int RB = kGather && V > 4 ? 4 : kRowsPerWarp;
  float ls[V], lb[V];
#pragma unroll
  for (int j = 0; j < V; ++j) ls[j] = vs[lane * V + j], lb[j] = vs[D + lane * V + j];

  // K4: lane i < 8 loads row wg + 8 i's indices and weights, merging the
  // weights of equal indices before the rounding to bf16, as the fma route
  // and the reference's summed one-hot rows do.
  int ia = 0, ib = 0, ic = 0;
  float ma = 0.0f, mb = 0.0f, mc = 0.0f;
  if constexpr (kGather) {
    const int n = n0 + wg + kGroupWarps * lane;
    if (lane < kRowsPerWarp && n < N) {
      const size_t o = ((size_t)b * N + n) * 3;
      ia = index[o], ib = index[o + 1], ic = index[o + 2];
      const float w0 = weight[o], w1 = weight[o + 1], w2 = weight[o + 2];
      ma = round_to<bf16>(w0 + (ib == ia ? w1 : 0.0f) + (ic == ia ? w2 : 0.0f));
      mb = ib == ia ? 0.0f : round_to<bf16>(w1 + (ic == ib ? w2 : 0.0f));
      mc = (ic == ia || ic == ib) ? 0.0f : round_to<bf16>(w2);
    }
  }
  const bf16* table = h1 + (size_t)bm * G * D + lane * V;

#pragma unroll 1
  for (int i0 = 0; i0 < kRowsPerWarp; i0 += RB) {
    constexpr int S = kGather ? 3 : 1;
    uint32_t raw[RB][S][V / 2];
    float m[RB][3];
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      const int i = i0 + k, n = n0 + wg + kGroupWarps * i;
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int q = 0; q < V / 2; ++q) raw[k][s][q] = 0u;
      if constexpr (kGather) {
        const int r0 = __shfl_sync(0xffffffffu, ia, i), r1 = __shfl_sync(0xffffffffu, ib, i),
                  r2 = __shfl_sync(0xffffffffu, ic, i);
        m[k][0] = __shfl_sync(0xffffffffu, ma, i);
        m[k][1] = __shfl_sync(0xffffffffu, mb, i);
        m[k][2] = __shfl_sync(0xffffffffu, mc, i);
        if (n < N) {
          load_bf16<V>(raw[k][0], table + (size_t)r0 * D);
          load_bf16<V>(raw[k][1], table + (size_t)r1 * D);
          load_bf16<V>(raw[k][2], table + (size_t)r2 * D);
        }
      } else if (n < N) {
        load_bf16<V>(raw[k][0], h1 + ((size_t)bm * N + n) * D + lane * V);
      }
    }
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      float x[V];
#pragma unroll
      for (int q = 0; q < V / 2; ++q) {
        if constexpr (kGather) {
          float lo = m[k][0] * lo_f32(raw[k][0][q]), hi = m[k][0] * hi_f32(raw[k][0][q]);
          lo = fmaf(m[k][1], lo_f32(raw[k][1][q]), lo);
          hi = fmaf(m[k][1], hi_f32(raw[k][1][q]), hi);
          lo = fmaf(m[k][2], lo_f32(raw[k][2][q]), lo);
          hi = fmaf(m[k][2], hi_f32(raw[k][2][q]), hi);
          x[2 * q] = round_to<bf16>(lo), x[2 * q + 1] = round_to<bf16>(hi);
        } else {
          x[2 * q] = lo_f32(raw[k][0][q]), x[2 * q + 1] = hi_f32(raw[k][0][q]);
        }
      }
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < V; ++j) s += x[j];
      const float mean = warp_sum(s) / D;
      float q2 = 0.0f;
#pragma unroll
      for (int j = 0; j < V; ++j) q2 += (x[j] - mean) * (x[j] - mean);
      const float inv = rsqrtf(warp_sum(q2) / D + 1e-5f);
      uint32_t y[V / 2];
#pragma unroll
      for (int q = 0; q < V / 2; ++q)
        y[q] = pack_bf16(gelu_erf((x[2 * q] - mean) * inv * ls[2 * q] + lb[2 * q]),
                         gelu_erf((x[2 * q + 1] - mean) * inv * ls[2 * q + 1] + lb[2 * q + 1]));
      store_bf16<V>(xs + (wg + kGroupWarps * (i0 + k)) * ld + lane * V, y);
    }
  }
}

// kGather: K4 (rows gathered from the token table h1 [BM, G, D] by index /
// weight [B, N, 3]); otherwise K11 (h1 is x [BM, N, D]).
template <int D, bool kGather>
__global__ void __launch_bounds__(kMmaThreads, 1)
interp_upscale_mma_kernel(const bf16* __restrict__ h1, const int* __restrict__ index,
                          const float* __restrict__ weight, const float* __restrict__ ln_s,
                          const float* __restrict__ ln_b, const bf16* __restrict__ w,
                          const float* __restrict__ bias, const bf16* __restrict__ hyper,
                          float* __restrict__ out, int BM, int M, int G, int N, int C) {
  using namespace psam;
  using L = MmaLayout<D>;
  constexpr int ld = L::ld, NT = D / 32;  // NT n8 tiles: a warp's D / 4 Dense columns
  extern __shared__ __align__(128) unsigned char smem_mma[];
  unsigned char* smem = smem_mma;
  bf16* ws = reinterpret_cast<bf16*>(smem);
  float* vs = reinterpret_cast<float*>(smem + L::w_bytes);
  const int grp = threadIdx.x / kGroupThreads, gt = threadIdx.x % kGroupThreads;
  const int wg = gt >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  unsigned char* own = smem + L::w_bytes + L::vec_bytes + grp * L::group_bytes;
  bf16* xs = reinterpret_cast<bf16*>(own);                    // A tile, then H
  bf16* hyp = reinterpret_cast<bf16*>(own + L::tile_bytes);
  float* stage = reinterpret_cast<float*>(own);               // over H, after the dot

  copy_tile_async(ws, ld, w, D, 0, D, D, 0, D, D);
  cp_async_commit();
  for (int e = threadIdx.x; e < D; e += blockDim.x)
    vs[e] = ln_s[e], vs[D + e] = ln_b[e], vs[2 * D + e] = bias[e];
  cp_async_wait_all();
  __syncthreads();

  const int tiles = (N + kRows - 1) / kRows;
  const long long items = (long long)tiles * BM;
  int cur = -1;
  for (long long item = (long long)blockIdx.x * kGroups + grp; item < items;
       item += (long long)gridDim.x * kGroups) {
    const int bm = (int)(item / tiles), n0 = (int)(item % tiles) * kRows;
    if (bm != cur) {  // the replica's hyper rows, zero past C
      copy_tile_async(hyp, ld, hyper + (size_t)bm * C * D, D, 0, kHypRows, C, 0, D, D, gt,
                      kGroupThreads);
      cp_async_commit();
      cur = bm;
    }
    tile_rows<D, kGather>(xs, vs, h1, index, weight, bm, bm / M, G, N, n0, wg, lane);
    cp_async_wait_all();
    group_sync(grp);

    {  // 2. H = GELU(round(round(A W) + round(b))), on the fragments
      const int rg = wg >> 2, c0 = (wg & 3) * (D / 4);
      float acc[2][NT][4];
      zero_acc(acc);
      mma_smem<2, 2, NT>(acc, xs, ld, 32 * rg, 0, ws, ld, 0, c0, D / 16, NT / 2);
      group_sync(grp);  // every warp has read the A tile
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = c0 + 8 * j + 2 * t4;
        const float b0 = round_to<bf16>(vs[2 * D + col]);
        const float b1 = round_to<bf16>(vs[2 * D + col + 1]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float y0 = round_to<bf16>(round_to<bf16>(acc[mt][j][2 * h]) + b0);
            const float y1 = round_to<bf16>(round_to<bf16>(acc[mt][j][2 * h + 1]) + b1);
            const int row = 32 * rg + 16 * mt + g + 8 * h;
            *reinterpret_cast<uint32_t*>(xs + row * ld + col) =
                pack_bf16(gelu_erf(y0), gelu_erf(y1));
          }
      }
    }
    group_sync(grp);

    {  // 3. logits = H hyper^T: warp (kh, mt) sums rows 16 mt.. over half kh of D
      const int mt = wg & 3, kh = wg >> 2;
      float acc[1][2][4];
      zero_acc(acc);
      mma_smem_nt<2, 1, 2>(acc, xs, ld, 16 * mt, kh * (D / 2), hyp, ld, kh * (D / 2), 0,
                           D / 32, 1);
      group_sync(grp);  // every warp has read H
      float* st = stage + kh * kHypRows * kStageLd;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          st[(8 * j + 2 * t4 + (i & 1)) * kStageLd + 16 * mt + g + 8 * (i >> 1)] = acc[0][j][i];
    }
    group_sync(grp);
    for (int e = gt; e < C * kRows; e += kGroupThreads) {
      const int c = e / kRows, r = e % kRows;
      if (n0 + r < N)
        out[((size_t)bm * C + c) * N + n0 + r] =
            stage[c * kStageLd + r] + stage[(kHypRows + c) * kStageLd + r];
    }
    group_sync(grp);  // the staging is read before the next tile's rows overwrite it
  }
}

// ------------------------------------------------------------ launches
int smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

// Each kernel's shared-memory limit is raised once, at its first launch
// (the port runs on one device); a launch that needs more fails and its
// error is returned.
template <typename T, bool kGather>
int launch_fma(const void* h1, const void* index, const void* weight, const void* ln_s,
               const void* ln_b, const void* w, const void* b, const void* hyper, void* out,
               int B, int M, int G, int N, int D, int C, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      interp_upscale_kernel<T, kGather>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_optin());
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem = (size_t)(kTile * D + kTile * (D + 1) + C * D) * sizeof(float);
  dim3 grid((N + kTile - 1) / kTile, B * M);
  interp_upscale_kernel<T, kGather><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(h1), static_cast<const int*>(index),
      static_cast<const float*>(weight), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<const T*>(w), static_cast<const float*>(b),
      static_cast<const T*>(hyper), static_cast<float*>(out), M, G, N, D, C);
  return (int)cudaGetLastError();
}

// One block an SM (as many as fit), each walking (tile, replica) items.
template <int D, bool kGather>
int launch_mma(const void* h1, const void* index, const void* weight, const void* ln_s,
               const void* ln_b, const void* w, const void* b, const void* hyper, void* out,
               int B, int M, int G, int N, int C, cudaStream_t stream) {
  constexpr int smem = MmaLayout<D>::total;
  static const cudaError_t attr = cudaFuncSetAttribute(
      interp_upscale_mma_kernel<D, kGather>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  static const int slots = [] {
    int dev = 0, sms = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, interp_upscale_mma_kernel<D, kGather>,
                                                  kMmaThreads, MmaLayout<D>::total);
    return sms * (per > 0 ? per : 1);
  }();
  if (!aligned16(h1) || !aligned16(w) || !aligned16(hyper))
    return (int)cudaErrorMisalignedAddress;
  const long long items = (long long)((N + kRows - 1) / kRows) * B * M;
  const int grid = (int)std::min<long long>(slots, (items + kGroups - 1) / kGroups);
  interp_upscale_mma_kernel<D, kGather><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(h1), static_cast<const int*>(index),
      static_cast<const float*>(weight), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(w),
      static_cast<const float*>(b), static_cast<const bf16*>(hyper), static_cast<float*>(out),
      B * M, M, G, N, C);
  return (int)cudaGetLastError();
}

// route 0 = fma, 1 = mma (bf16, D = 128 or 256, C <= kMaxC).
template <bool kGather>
int launch(const void* h1, const void* index, const void* weight, const void* ln_s,
           const void* ln_b, const void* w, const void* b, const void* hyper, void* out, int B,
           int M, int G, int N, int D, int C, int dtype, int route, cudaStream_t st) {
  if (route == 1) {
    if (dtype != 1 || C > kMaxC) return (int)cudaErrorInvalidValue;
    switch (D) {
      case 128:
        return launch_mma<128, kGather>(h1, index, weight, ln_s, ln_b, w, b, hyper, out, B, M,
                                        G, N, C, st);
      case 256:
        return launch_mma<256, kGather>(h1, index, weight, ln_s, ln_b, w, b, hyper, out, B, M,
                                        G, N, C, st);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (route != 0 || D > 32 * psam::kMaxPerLane) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch_fma<bf16, kGather>(h1, index, weight, ln_s, ln_b, w, b, hyper, out, B, M, G,
                                     N, D, C, st);
  return launch_fma<float, kGather>(h1, index, weight, ln_s, ln_b, w, b, hyper, out, B, M, G,
                                    N, D, C, st);
}

}  // namespace

// h1 [B*M, G, D], w [D, D] ([in, out]) and hyper [B*M, C, D] in the compute
// dtype (0 = float32, 1 = bfloat16); index [B, N, 3] int32 in [0, G);
// weight [B, N, 3], ln_s, ln_b, b [D] fp32; out [B*M, C, N] fp32; route 0
// (fma, D <= 512) or 1 (mma: bf16, D = 128 or 256, C <= 8).
extern "C" int psam_interp_upscale(const void* h1, const void* index, const void* weight,
                                   const void* ln_s, const void* ln_b, const void* w,
                                   const void* b, const void* hyper, void* out, int B, int M,
                                   int G, int N, int D, int C, int dtype, int route,
                                   void* stream) {
  if (B <= 0 || M <= 0 || G <= 0 || N <= 0 || D <= 0 || C <= 0)
    return (int)cudaErrorInvalidValue;
  return launch<true>(h1, index, weight, ln_s, ln_b, w, b, hyper, out, B, M, G, N, D, C, dtype,
                      route, static_cast<cudaStream_t>(stream));
}

// K11: x [BM, N, D], w [D, D] ([in, out]) and hyper [BM, C, D] in the
// compute dtype (0 = float32, 1 = bfloat16); ln_s, ln_b, b [D] fp32;
// out [BM, C, N] fp32; route as psam_interp_upscale's.
extern "C" int psam_upscale_hyper(const void* x, const void* ln_s, const void* ln_b,
                                  const void* w, const void* b, const void* hyper, void* out,
                                  int BM, int N, int D, int C, int dtype, int route,
                                  void* stream) {
  if (BM <= 0 || N <= 0 || D <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  // One cloud per replica (B = BM, M = 1): item (tile, bm) reads rows of x[bm].
  return launch<false>(x, nullptr, nullptr, ln_s, ln_b, w, b, hyper, out, BM, 1, N, N, D, C,
                       dtype, route, static_cast<cudaStream_t>(stream));
}
