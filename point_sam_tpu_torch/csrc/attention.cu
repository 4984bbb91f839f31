// K3: dense unmasked multi-head softmax attention on [B, S, D] projections,
// and K5: the same on head-split [B, H, S, dh] tensors.
//
// K3 replaces point_sam_tpu/ops/attention.py::mha_packed_pallas
// (_mha_packed_kernel), K5 replaces mha_pallas (_mha_kernel), the
// head-split kernel the JAX package takes for head sizes other than 64 and
// 128 (EVA-giant: D=1408, 16 heads, dh=88). Both compute, per head,
// softmax(q k^T * scale) v with fp32 logits and softmax, the scale folded
// into q when it is a power of two (exact; 1/sqrt(88) is not, so K5 at
// dh=88 scales the fp32 logits), e rounded to v's dtype before the PV
// product, and the normalisation applied after it. The two entries share
// the kernels below; they differ only in addressing: a (batch, head) tile
// starts at b * bstride + h * hstride and its rows are ld elements apart
// ([B, S, D]: S*D, dh, D; [B, H, S, dh]: H*S*dh, S*dh, dh).
//
// What bounds it on the H100: at the ViT-L shape (S=2048, dh=64, 16 heads)
// the [S, S] logits per head are 16 MB in fp32; written to device memory
// they would make the layer bandwidth-bound, so they never leave the SM,
// and the two S x S x dh products (17 GFLOP per call) bound it.
// K5 at the EVA-giant shape ([1, 16, 2048, 88]) does 23.6 GFLOP per call.
// Design: one block per (batch, head, 64-query tile) streams 64-key tiles
// of K and V straight from either layout (head offset and row stride, no
// transposes) into shared memory and keeps an online fp32 softmax (running
// max and sum per query row).
// - bf16: each of the 4 warps owns 16 query rows; Q K^T and P V run on the
//   tensor cores (WMMA 16x16x16, fp32 accumulation), the softmax of the
//   warp's rows in fp32 on the CUDA cores, and the output accumulator
//   stays in shared memory in fp32 (rescaled per tile).
// - fp32: plain FMA; each thread owns 4 query rows x 8 key columns of a
//   tile and 4 rows x dh/8 output columns.
// Any S (ragged last tiles are masked) and any dh <= 128 (zero-padded to
// 32, 64, 96 or 128; dh=88 runs at 96).
#include <mma.h>

#include <type_traits>

#include "common.cuh"

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

// bf16 tensor-core variant. Shared memory: Q, K, V tiles in bf16 [64][DHP+8],
// logits S fp32 [64][68], probabilities P bf16 [64][72], output O fp32
// [64][DHP+4], row max / sum fp32 [64] each.
template <int DHP>
__global__ void __launch_bounds__(kThreads)
mha_kernel_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int S,
              size_t bstride, size_t hstride, int D, int dh, float scale, int fold) {
  using namespace nvcuda;
  using bf16 = __nv_bfloat16;
  constexpr int LDB = DHP + 8, LDS = kBK + 4, LDP = kBK + 8, LDO = DHP + 4;
  extern __shared__ __align__(128) float sm[];
  bf16* Qs = reinterpret_cast<bf16*>(sm);
  bf16* Ks = Qs + kBQ * LDB;
  bf16* Vs = Ks + kBK * LDB;
  float* Ss = reinterpret_cast<float*>(Vs + kBK * LDB);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + kBQ * LDS);
  float* Os = reinterpret_cast<float*>(Ps + kBQ * LDP);
  float* row_m = Os + kBQ * LDO;
  float* row_l = row_m + kBQ;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ;
  const size_t base = blockIdx.z * bstride + blockIdx.y * hstride;  // D: row stride
  // 16-byte row segments (every tile start is then 16-byte aligned too).
  const bool vec = (dh & 7) == 0 && (D & 7) == 0 && (hstride & 7) == 0 && (bstride & 7) == 0;

  // Load a [64 x DHP] tile (rows r0.., zero past S and past dh).
  auto load_tile = [&](const bf16* src, int r0, bf16* dst, bool scale_q) {
    if (vec && !(scale_q && fold)) {
      for (int e = tid; e < 64 * (DHP / 8); e += kThreads) {
        const int r = e / (DHP / 8), c = (e % (DHP / 8)) * 8;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (r0 + r < S && c < dh)
          val = *reinterpret_cast<const uint4*>(src + base + (size_t)(r0 + r) * D + c);
        *reinterpret_cast<uint4*>(dst + r * LDB + c) = val;
      }
    } else {
      for (int e = tid; e < 64 * DHP; e += kThreads) {
        const int r = e / DHP, c = e % DHP;
        float x = 0.0f;
        if (r0 + r < S && c < dh) {
          x = __bfloat162float(src[base + (size_t)(r0 + r) * D + c]);
          if (scale_q && fold) x *= scale;  // power of two: exact
        }
        dst[r * LDB + c] = __float2bfloat16_rn(x);
      }
    }
  };

  load_tile(q, q0, Qs, true);
  for (int e = tid; e < kBQ * LDO; e += kThreads) Os[e] = 0.0f;
  for (int r = tid; r < kBQ; r += kThreads) {
    row_m[r] = -INFINITY;
    row_l[r] = 0.0f;
  }

  const int r_w = warp * 16;  // this warp's 16 query rows
  for (int k0 = 0; k0 < S; k0 += kBK) {
    __syncthreads();  // previous K/V tile fully consumed
    load_tile(k, k0, Ks, false);
    load_tile(v, k0, Vs, false);
    __syncthreads();

    // S[r_w:r_w+16, 0:64] = Q K^T
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBK / 16];
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
      for (int d = 0; d < DHP; d += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Qs + r_w * LDB + d, LDB);
#pragma unroll
        for (int j = 0; j < kBK / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bk;
          wmma::load_matrix_sync(bk, Ks + (j * 16) * LDB + d, LDB);
          wmma::mma_sync(acc[j], a, bk, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j)
        wmma::store_matrix_sync(Ss + r_w * LDS + j * 16, acc[j], LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax of the warp's rows: lanes hold columns lane, lane+32.
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r_w + rr;
      float x0 = Ss[r * LDS + lane], x1 = Ss[r * LDS + lane + 32];
      if (!fold) { x0 *= scale; x1 *= scale; }
      if (k0 + lane >= S) x0 = -INFINITY;
      if (k0 + lane + 32 >= S) x1 = -INFINITY;
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, psam::warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      Ps[r * LDP + lane] = __float2bfloat16_rn(p0);
      Ps[r * LDP + lane + 32] = __float2bfloat16_rn(p1);
      const float alpha = expf(m_old - m_new);  // 0 on the first tile
      const float rowsum = psam::warp_sum(p0 + p1);
      for (int c = lane; c < DHP; c += 32) Os[r * LDO + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        row_l[r] = row_l[r] * alpha + rowsum;
        row_m[r] = m_new;
      }
    }
    __syncwarp();

    // O[r_w:r_w+16, :] += P V
#pragma unroll
    for (int n0 = 0; n0 < DHP; n0 += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Os + r_w * LDO + n0, LDO, wmma::mem_row_major);
#pragma unroll
      for (int j = 0; j < kBK; j += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, Ps + r_w * LDP + j, LDP);
        wmma::load_matrix_sync(bv, Vs + j * LDB + n0, LDB);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(Os + r_w * LDO + n0, acc, LDO, wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int e = tid; e < kBQ * DHP; e += kThreads) {
    const int r = e / DHP, c = e % DHP;
    if (q0 + r < S && c < dh)
      o[base + (size_t)(q0 + r) * D + c] = __float2bfloat16_rn(Os[r * LDO + c] / row_l[r]);
  }
}

template <typename T, int DHP>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int dh,
           size_t bstride, size_t hstride, int ld, float scale, int fold, cudaStream_t stream) {
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const size_t smem = (size_t)(3 * 64 * (DHP + 8)) * 2 + (size_t)kBQ * (kBK + 4) * 4 +
                        (size_t)kBQ * (kBK + 8) * 2 + (size_t)kBQ * (DHP + 4) * 4 + 2 * kBQ * 4;
    cudaError_t err = cudaFuncSetAttribute(
        mha_kernel_tc<DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    mha_kernel_tc<DHP><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), S, bstride, hstride, ld, dh, scale, fold);
    return (int)cudaGetLastError();
  } else {
    const size_t smem = (size_t)(3 * kBQ * (DHP + 1) + kBQ * (kBK + 1)) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        mha_kernel<T, DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
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
// bfloat16 (dtype 1). fold != 0: scale is a power of two, applied to q.
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
