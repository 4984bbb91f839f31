// K3: dense unmasked multi-head softmax attention on [B, S, D] projections,
// and K5: the same on head-split [B, H, S, dh] tensors.
//
// K3 replaces point_sam_tpu/ops/attention.py:178 (_mha_packed_kernel, behind
// mha_packed_pallas), K5 replaces point_sam_tpu/ops/attention.py:41
// (_mha_kernel, behind mha_pallas), the head-split kernel the JAX package
// takes for head sizes other than 64 and 128 (EVA-giant: D=1408, 16 heads,
// dh=88). Both compute, per head, softmax(q k^T * scale) v with fp32 logits
// and softmax, e rounded to v's dtype before the PV product, PV summed in
// fp32 and the normalisation by the fp32 row sum applied after it. The two
// entries share the kernels below; they differ only in addressing: a
// (batch, head) tile starts at b * bstride + h * hstride and its rows are ld
// elements apart ([B, S, D]: S*D, dh, D; [B, H, S, dh]: H*S*dh, S*dh, dh).
// Any S (ragged last tiles are masked) and any dh <= 128 (zero-padded to
// 32, 64, 96 or 128 columns: DHP; dh=88 runs at 96).
//
// What bounds it on the H100: the two S x S x dh products. At the ViT-L
// shape (K3, [1, 2048, 1024], 16 heads of 64) they are 17.2 GFLOP per call,
// 17 us at 989 TFLOP/s bf16; at the EVA-giant shape (K5, [1, 16, 2048, 88])
// 23.6 GFLOP, 24 us. The inputs and output are 16 MB and 23 MB (5-7 us at
// 3.35 TB/s). The [S, S] logits per head (16 MB in fp32) would make it
// bandwidth-bound if they left the SM, so they never leave the registers.
//
// bf16 (mha_kernel_mma), FlashAttention-2's shape on mma.sync: one block of
// 4 warps per (batch, head, 64-query tile); each warp owns 16 query rows.
// - Q's A-fragments are loaded once (ldmatrix) and stay in registers.
// - K and V stream in 64-key tiles through a double buffer in shared
//   memory, filled by 16-byte cp.async.cg (rows past S zero-filled with
//   src-size 0; the padding columns dh..DHP zeroed once, never copied): the
//   copy of tile j+1 is issued right after the one barrier of tile j and runs
//   while tile j is used (tile 0 has one more barrier: Q passes through the
//   second stage). Rows are DHP + 8 elements apart, so the 8 rows of each
//   ldmatrix fall on distinct banks. 36 / 52 / 68 KB at DHP 64 / 96 / 128,
//   and at most 128 registers a thread up to DHP=96: 4 blocks (16 warps) per
//   SM, so a 512-block grid (16 heads x 32 query tiles) is one wave.
// - S = Q K^T accumulates in m16n8k16 C fragments (mma.sync bf16, fp32
//   accumulation; K's B-fragments by ldmatrix): a thread holds 2 rows x 2
//   columns of each n8 tile. The online softmax runs on those registers: the
//   row max and sum reduce over the 4 lanes of a row (shuffles 1 and 2), and
//   the running max and (per-lane partial) sum stay in registers.
// - The C layout of two adjacent n8 tiles is the A layout of one k16 step,
//   so P is packed to bf16x2 in registers and fed straight into P V (V's
//   B-fragments by ldmatrix.trans). O (16 x DHP fp32 per warp) accumulates
//   in registers, is rescaled there by alpha, divided by the row sum once at
//   the end and leaves through shared memory as 16-byte stores.
// - The scale multiplies the fp32 logits inside the exponent: e =
//   exp2(s * (scale * log2 e) - m * (scale * log2 e)), one FFMA and ex2.approx
//   per element. Against the plain version's exp(s * scale - max) that is one
//   more fp32 rounding (scale * log2 e) and ex2.approx's 2-ulp error, far
//   inside the bf16 tolerance. (For a power-of-two scale, scaling the logits
//   or folding it into q is the same bit for bit.)
// fp32 (mha_kernel): plain FMA; each thread owns 4 query rows x 8 key
// columns of a tile and 4 rows x dh/8 output columns; the scale folded into q
// when it is a power of two (exact; 1/sqrt(88) is not, so dh=88 scales the
// fp32 logits).
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 128;

template <typename T, int DHP>
__global__ void __launch_bounds__(kThreads)
mha_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, int S, size_t bstride, size_t hstride, int D, int dh,
           float scale, int fold) {
  using namespace psam;
  constexpr int LD = DHP + 1;
  constexpr int LP = kBK + 1;
  constexpr int OC = DHP / 8;
  extern __shared__ float sm[];
  float* Qs = sm;             // [kBQ][LD]
  float* Ks = Qs + kBQ * LD;  // [kBK][LD]
  float* Vs = Ks + kBK * LD;  // [kBK][LD]
  float* Ps = Vs + kBK * LD;  // [kBQ][LP]

  const int tid = threadIdx.x;
  const int g = tid & 7;    // key / output column group
  const int rg = tid >> 3;  // query row group (rows rg + 16 i)
  const int q0 = blockIdx.x * kBQ;
  const size_t base = blockIdx.z * bstride + blockIdx.y * hstride;  // D: row stride

  for (int e = tid; e < kBQ * DHP; e += kThreads) {
    const int r = e / DHP, c = e % DHP;
    float val = 0.0f;
    if (q0 + r < S && c < dh) {
      val = to_f32<T>(q[base + (size_t)(q0 + r) * D + c]);
      if (fold) val = round_to<T>(val * scale);
    }
    Qs[r * LD + c] = val;
  }

  float m_i[4], l_i[4], acc[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.0f;
  }

  for (int k0 = 0; k0 < S; k0 += kBK) {
    __syncthreads();  // previous tile fully consumed
    for (int e = tid; e < kBK * DHP; e += kThreads) {
      const int r = e / DHP, c = e % DHP;
      float kv = 0.0f, vv = 0.0f;
      if (k0 + r < S && c < dh) {
        const size_t off = base + (size_t)(k0 + r) * D + c;
        kv = to_f32<T>(k[off]);
        vv = to_f32<T>(v[off]);
      }
      Ks[r * LD + c] = kv;
      Vs[r * LD + c] = vv;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < DHP; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(rg + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(g + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

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
      // The 8 threads of one row group are lanes differing in bits 0-2.
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);  // 0 on the first tile
      float rowsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        rowsum += p;
        // P is rounded to v's dtype before the PV product, as in the
        // reference kernel; the denominator keeps the fp32 values.
        Ps[(rg + 16 * i) * LP + g + 8 * j] = round_to<T>(p);
      }
      rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 1);
      rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 2);
      rowsum += __shfl_xor_sync(0xffffffffu, rowsum, 4);
      l_i[i] = l_i[i] * alpha + rowsum;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int j = 0; j < kBK; ++j) {
      float pv[4], vv[OC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(rg + 16 * i) * LP + j];
#pragma unroll
      for (int c = 0; c < OC; ++c) vv[c] = Vs[j * LD + g + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < OC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + rg + 16 * i;
    if (r >= S) continue;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int col = g + 8 * c;
      if (col < dh) o[base + (size_t)r * D + col] = from_f32<T>(acc[i][c] / l_i[i]);
    }
  }
}

// ---- bf16: register-resident mma.sync fragments, cp.async K/V pipeline ----

// Shared memory: two stages of [K tile][V tile], each tile [64][DHP+8] bf16.
// Q passes through stage 1 before tile 1 arrives there, and the output
// leaves through the stage the last tile does not use. vec: 16-byte rows and
// base (dh % 8 == 0, ld and the strides multiples of 8 elements, pointers
// 16-byte aligned), else element loads. Registers are capped so that 4
// blocks fit an SM up to DHP=96 (3 at 128): a 512-block grid (the serve,
// train and voronoi shapes) then runs in one wave on 132 SMs.
template <int DHP>
__global__ void __launch_bounds__(kThreads, DHP <= 96 ? 4 : 3)
mha_kernel_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S,
               size_t bstride, size_t hstride, int ld, int dh, float scale_log2, int vec) {
  using namespace psam;
  using bf16 = __nv_bfloat16;
  static_assert(kBQ == kBK && kBQ == 16 * (kThreads / 32), "16 query rows per warp");
  constexpr int LDS = DHP + 8;   // row stride, elements
  constexpr int TILE = kBK * LDS;
  constexpr int CH = DHP / 8;    // 16-byte chunks per row
  constexpr int KSTEPS = DHP / 16;
  constexpr int NT = kBK / 8;    // n8 tiles of S
  constexpr int OT = DHP / 8;    // n8 tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* const sm = reinterpret_cast<bf16*>(smem_raw);  // stage b: K at 2b, V at 2b + 1
  bf16* const Qs = sm + 2 * TILE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row group, column pair
  const int q0 = blockIdx.x * kBQ;
  const size_t base = blockIdx.z * bstride + blockIdx.y * hstride;
  const int ntiles = (S + kBK - 1) / kBK;

  // Columns dh..DHP of all four tiles are zero for the whole run.
  const bf16 zero = __float2bfloat16_rn(0.0f);
  for (int e = tid; e < 4 * kBK * (DHP - dh); e += kThreads) {
    const int r = e / (DHP - dh), c = dh + e % (DHP - dh);
    sm[r * LDS + c] = zero;
  }

  // Rows r0.. of a [64 x dh] tile into dst (rows past S zero). r0 < S.
  auto load_tile = [&](const bf16* src, int r0, bf16* dst) {
    if (vec) {
      for (int e = tid; e < kBK * CH; e += kThreads) {
        const int r = e / CH, c = (e % CH) * 8;
        if (c >= dh) continue;
        const bool in = r0 + r < S;
        cp_async16(smem_u32(dst + r * LDS + c), src + base + (size_t)(in ? r0 + r : r0) * ld + c,
                   in);
      }
    } else {
      for (int e = tid; e < kBK * dh; e += kThreads) {
        const int r = e / dh, c = e % dh;
        dst[r * LDS + c] = r0 + r < S ? src[base + (size_t)(r0 + r) * ld + c] : zero;
      }
    }
  };

  load_tile(q, q0, Qs);
  load_tile(k, 0, sm);
  load_tile(v, 0, sm + TILE);
  cp_async_commit();

  uint32_t qf[KSTEPS][4];
  float oacc[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) oacc[n][i] = 0.0f;
  float m_r[2] = {-INFINITY, -INFINITY};  // running max of rows g, g + 8 (unscaled logits)
  float l_r[2] = {0.0f, 0.0f};            // this lane's part of their running sums

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t visible; tile t - 1's stage free
    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        ldmatrix_x4(qf[ks], smem_u32(Qs + (warp * 16 + (lane & 15)) * LDS + ks * 16 +
                                     (lane >> 4) * 8));
      __syncthreads();  // Q is in registers: tile 1 may overwrite it
    }
    if (t + 1 < ntiles) {
      bf16* const next = sm + ((t + 1) & 1) * 2 * TILE;
      load_tile(k, (t + 1) * kBK, next);
      load_tile(v, (t + 1) * kBK, next + TILE);
      cp_async_commit();
    }
    const bf16* Kt = sm + (t & 1) * 2 * TILE;
    const bf16* Vt = Kt + TILE;

    // S = Q K^T for the warp's 16 rows and the tile's 64 keys.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, smem_u32(Kt + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS +
                                ks * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * jp], qf[ks], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf[ks], b[2], b[3]);
      }
    }

    const int k0 = t * kBK;
    if (k0 + kBK > S) {  // keys past S: -inf before the max
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (k0 + 8 * j + 2 * t4 + e >= S) s[j][e] = s[j][2 + e] = -INFINITY;
    }

    // Online softmax on the registers: rows g (i = 0) and g + 8 (i = 1).
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
      alpha[i] = exp2_approx((m_r[i] - mx[i]) * scale_log2);  // 0 on the first tile
      m_r[i] = mx[i];
      ms[i] = mx[i] * scale_log2;
    }
    uint32_t pa[NT / 2][4];  // P as the A-fragments of the k16 steps of P V
    float ls[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float p0 = exp2_approx(fmaf(s[j][0], scale_log2, -ms[0]));
      const float p1 = exp2_approx(fmaf(s[j][1], scale_log2, -ms[0]));
      const float p2 = exp2_approx(fmaf(s[j][2], scale_log2, -ms[1]));
      const float p3 = exp2_approx(fmaf(s[j][3], scale_log2, -ms[1]));
      ls[0] += p0 + p1;  // the sums keep the fp32 values
      ls[1] += p2 + p3;
      pa[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = l_r[i] * alpha[i] + ls[i];
#pragma unroll
    for (int n = 0; n < OT; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }

    // O += P V.
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
      for (int dp = 0; dp < OT / 2; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, smem_u32(Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                                      dp * 16 + (lane >> 4) * 8));
        mma_bf16(oacc[2 * dp], pa[kk], b[0], b[1]);
        mma_bf16(oacc[2 * dp + 1], pa[kk], b[2], b[3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
  // The warp's rows of the stage the last tile left free (Q's stage at one
  // tile) hold the output rows for 16-byte stores.
  bf16* const Os = sm + (ntiles & 1) * 2 * TILE + warp * 16 * LDS;
#pragma unroll
  for (int n = 0; n < OT; ++n) {
    const int c = n * 8 + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(Os + g * LDS + c) =
        __floats2bfloat162_rn(oacc[n][0] / l_r[0], oacc[n][1] / l_r[0]);
    *reinterpret_cast<__nv_bfloat162*>(Os + (g + 8) * LDS + c) =
        __floats2bfloat162_rn(oacc[n][2] / l_r[1], oacc[n][3] / l_r[1]);
  }
  __syncwarp();
  const int r_w = q0 + warp * 16;
  if (vec) {
    for (int e = lane; e < 16 * CH; e += 32) {
      const int r = e / CH, c = (e % CH) * 8;
      if (r_w + r < S && c < dh)
        *reinterpret_cast<uint4*>(o + base + (size_t)(r_w + r) * ld + c) =
            *reinterpret_cast<const uint4*>(Os + r * LDS + c);
    }
  } else {
    for (int e = lane; e < 16 * dh; e += 32) {
      const int r = e / dh, c = e % dh;
      if (r_w + r < S) o[base + (size_t)(r_w + r) * ld + c] = Os[r * LDS + c];
    }
  }
}

template <typename T, int DHP>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int dh,
           size_t bstride, size_t hstride, int ld, float scale, int fold, cudaStream_t stream) {
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  // The shared-memory limit is raised once per instantiation, at its first
  // launch (the port runs on one device).
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const size_t smem = (size_t)4 * kBK * (DHP + 8) * sizeof(__nv_bfloat16);
    static const cudaError_t attr = cudaFuncSetAttribute(
        mha_kernel_mma<DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return (int)attr;
    auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
    const int vec = (dh & 7) == 0 && (ld & 7) == 0 && (hstride & 7) == 0 &&
                    (bstride & 7) == 0 && aligned(q) && aligned(k) && aligned(v) && aligned(o);
    constexpr float kLog2e = 1.4426950408889634f;
    mha_kernel_mma<DHP><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), S, bstride, hstride, ld, dh, scale * kLog2e, vec);
    return (int)cudaGetLastError();
  } else {
    const size_t smem = (size_t)(3 * kBQ * (DHP + 1) + kBQ * (kBK + 1)) * sizeof(float);
    static const cudaError_t attr = cudaFuncSetAttribute(
        mha_kernel<T, DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (attr != cudaSuccess) return (int)attr;
    mha_kernel<T, DHP><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), S, bstride, hstride, ld, dh, scale, fold);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int dh,
             size_t bstride, size_t hstride, int ld, float scale, int fold,
             cudaStream_t stream) {
  if (dh <= 32)
    return launch<T, 32>(q, k, v, o, B, S, H, dh, bstride, hstride, ld, scale, fold, stream);
  if (dh <= 64)
    return launch<T, 64>(q, k, v, o, B, S, H, dh, bstride, hstride, ld, scale, fold, stream);
  if (dh <= 96)
    return launch<T, 96>(q, k, v, o, B, S, H, dh, bstride, hstride, ld, scale, fold, stream);
  return launch<T, 128>(q, k, v, o, B, S, H, dh, bstride, hstride, ld, scale, fold, stream);
}

int run(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int dh,
        size_t bstride, size_t hstride, int ld, float scale, int fold, int dtype,
        void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || dh <= 0 || dh > 128) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, S, H, dh, bstride, hstride, ld, scale, fold,
                                   st);
  return dispatch<float>(q, k, v, o, B, S, H, dh, bstride, hstride, ld, scale, fold, st);
}

}  // namespace

// K3. q, k, v, o: [B, S, H * dh] contiguous, dtype float32 (dtype 0) or
// bfloat16 (dtype 1). fold != 0: scale is a power of two, which the fp32
// kernel applies to q (the bf16 kernel scales the logits either way).
extern "C" int psam_attention(const void* q, const void* k, const void* v, void* o, int B,
                              int S, int H, int dh, float scale, int fold, int dtype,
                              void* stream) {
  const size_t D = (size_t)H * dh;
  return run(q, k, v, o, B, S, H, dh, (size_t)S * D, (size_t)dh, (int)D, scale, fold, dtype,
             stream);
}

// K5. q, k, v, o: [B, H, S, dh] contiguous; the rest as psam_attention.
extern "C" int psam_attention_heads(const void* q, const void* k, const void* v, void* o,
                                    int B, int H, int S, int dh, float scale, int fold,
                                    int dtype, void* stream) {
  return run(q, k, v, o, B, S, H, dh, (size_t)H * S * dh, (size_t)S * dh, dh, scale, fold,
             dtype, stream);
}
