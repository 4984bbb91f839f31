// Warp-tile building blocks over mma.cuh for the PointNet kernels (K2 in
// patch_encoder.cu, K7's passes C and D in patch_encoder_bwd.cu): bf16 products
// whose weights and activations both sit in shared memory, fed to
// mma.sync.m16n8k16 by ldmatrix, with fp32 accumulators in registers and
// the epilogues applied on the C fragments.
//
// Layouts: every matrix in shared memory is row-major bf16 with rows
// padded by 8 elements (16 bytes), so the 8 row addresses of one ldmatrix
// fall on distinct 16-byte bank groups when the row length is a multiple
// of 64. Weights are [k][n] (the flax ``kernel`` layout), read as
// B-fragments by ldmatrix.trans. A warp tile is MT m16 row tiles by 2 NP
// n8 column tiles; acc[m][j] holds the C fragment of row tile m, column
// tile j (see mma.cuh for the fragment maps).
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace psam {

// Block-cooperative 16-byte cp.async of rows [r0, r0 + rows) x columns
// [c0, c0 + cols) of a row-major bf16 matrix W (ldw elements a row) into
// dst (ldd elements a row); entries at or past row rmax or column cmax are
// zero-filled. cols, c0, ldw and cmax are multiples of 8, W is 16-byte
// aligned. The caller commits the group.
__device__ __forceinline__ void copy_tile_async(__nv_bfloat16* dst, int ldd,
                                                const __nv_bfloat16* __restrict__ W, int ldw,
                                                int r0, int rows, int rmax, int c0, int cols,
                                                int cmax) {
  const int chunks = cols >> 3;
  for (int e = threadIdx.x; e < rows * chunks; e += blockDim.x) {
    const int r = e / chunks, c = (e % chunks) << 3;
    const bool in = r0 + r < rmax && c0 + c < cmax;
    cp_async16(smem_u32(dst + r * ldd + c), in ? W + (size_t)(r0 + r) * ldw + c0 + c : W, in);
  }
}

// This lane's shared-memory byte address of the ldmatrix row it points at,
// for the A-fragments of the 16 x 16 tile at (r0, k0) of A (lda elements a
// row); the tile at (r0 + 16 m, k0 + 16 s) is 32 (m lda + s) bytes further.
__device__ __forceinline__ uint32_t a16_addr(const __nv_bfloat16* A, int lda, int r0, int k0) {
  const int lane = threadIdx.x & 31;
  return smem_u32(A + (r0 + (lane & 15)) * lda + k0 + (lane >> 4) * 8);
}

// The same for the B-fragments (ldmatrix.trans) of the two n8 tiles of the
// 16 x 16 tile at (k0, n0) of a [k][n] matrix B (ldb elements a row): b[0],
// b[1] for columns n0.., b[2], b[3] for n0 + 8..; the tile at (k0 + 16 s,
// n0 + 16 j) is 32 (s ldb + j) bytes further.
__device__ __forceinline__ uint32_t b16_addr(const __nv_bfloat16* B, int ldb, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  return smem_u32(B + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldb + n0 + (lane >> 4) * 8);
}

// The same for the A-fragments (ldmatrix.trans) of the 16 x 16 tile at (m0,
// k0) of A = S^T, where S is [k][m] in shared memory (lds elements a row),
// e.g. a weight-gradient product's S^T D over rows k: S's rows k0.., columns
// m0..; the tile at (m0 + 16 m, k0 + 16 s) is 32 (s lds + m) bytes further.
__device__ __forceinline__ uint32_t at16_addr(const __nv_bfloat16* S, int lds, int k0, int m0) {
  const int lane = threadIdx.x & 31;
  return smem_u32(S + (k0 + (lane & 7) + (lane >> 4) * 8) * lds + m0 + ((lane >> 3) & 1) * 8);
}

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.0f;
}

// acc += A[ar0 + 16 MT rows, ka + 16 nk] B[kb + 16 nk, bn0 + 16 np], both
// in shared memory; np <= NT / 2 column pairs (warp-uniform), the rest of
// acc untouched. The k16 steps run KU at a time, unrolled. Each B pair is
// loaded just before its products, which keeps few fragments live (the
// kernels run at 128 registers a thread; loading a whole step's fragments
// first, or the next step's during this one, spilled and was slower).
template <int KU, int MT, int NT>
__device__ __forceinline__ void mma_smem(float (&acc)[MT][NT][4], const __nv_bfloat16* A,
                                         int lda, int ar0, int ka, const __nv_bfloat16* B,
                                         int ldb, int kb, int bn0, int nk, int np) {
  const uint32_t a0 = a16_addr(A, lda, ar0, ka), b0 = b16_addr(B, ldb, kb, bn0);
  for (int k0 = 0; k0 < nk; k0 += KU) {
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      const int ks = k0 + u;
      if (ks < nk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) ldmatrix_x4(a[m], a0 + 32 * (m * lda + ks));
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          if (jp < np) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, b0 + 32 * (ks * ldb + jp));
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              mma_bf16(acc[m][2 * jp], a[m], b[0], b[1]);
              mma_bf16(acc[m][2 * jp + 1], a[m], b[2], b[3]);
            }
          }
        }
      }
    }
  }
}

// acc += S[sk0 + 16 nk, sm0 + 16 mt]^T B[kb + 16 nk, bn0 + 16 np], both in
// shared memory (S [k][m] row-major, its A-fragments by ldmatrix.trans); mt
// <= MT row tiles (warp-uniform), the rest of acc untouched; otherwise as
// mma_smem.
template <int KU, int MT, int NT>
__device__ __forceinline__ void mma_smem_tn(float (&acc)[MT][NT][4], const __nv_bfloat16* S,
                                            int lds, int sk0, int sm0, const __nv_bfloat16* B,
                                            int ldb, int kb, int bn0, int nk, int np,
                                            int mt = MT) {
  const uint32_t a0 = at16_addr(S, lds, sk0, sm0), b0 = b16_addr(B, ldb, kb, bn0);
  for (int k0 = 0; k0 < nk; k0 += KU) {
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      const int ks = k0 + u;
      if (ks < nk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          if (m < mt) ldmatrix_x4_trans(a[m], a0 + 32 * (ks * lds + m));
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          if (jp < np) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, b0 + 32 * (ks * ldb + jp));
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              if (m >= mt) continue;
              mma_bf16(acc[m][2 * jp], a[m], b[0], b[1]);
              mma_bf16(acc[m][2 * jp + 1], a[m], b[2], b[3]);
            }
          }
        }
      }
    }
  }
}

// This lane's shared-memory byte address for the B-fragments of B = W^T,
// where W is [n][k] row-major (ldw elements a row), by ldmatrix without
// .trans: the two n8 tiles of the 16 x 16 tile at (k0, n0) of B, b[0], b[1]
// for columns n0.., b[2], b[3] for n0 + 8..; the tile at (k0 + 16 s, n0 +
// 16 j) is 32 (s + j ldw) bytes further.
__device__ __forceinline__ uint32_t bt16_addr(const __nv_bfloat16* W, int ldw, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  return smem_u32(W + (n0 + (lane & 7) + ((lane >> 4) & 1) * 8) * ldw + k0 +
                  ((lane >> 3) & 1) * 8);
}

// acc += A[ar0 + 16 MT rows, ka + 16 nk] W[wn0 + 16 np, kw + 16 nk]^T, both
// in shared memory (W [n][k] row-major, e.g. a weight whose transpose is
// the product's B); otherwise as mma_smem.
template <int KU, int MT, int NT>
__device__ __forceinline__ void mma_smem_nt(float (&acc)[MT][NT][4], const __nv_bfloat16* A,
                                            int lda, int ar0, int ka, const __nv_bfloat16* W,
                                            int ldw, int kw, int wn0, int nk, int np) {
  const uint32_t a0 = a16_addr(A, lda, ar0, ka), b0 = bt16_addr(W, ldw, kw, wn0);
  for (int k0 = 0; k0 < nk; k0 += KU) {
#pragma unroll
    for (int u = 0; u < KU; ++u) {
      const int ks = k0 + u;
      if (ks < nk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) ldmatrix_x4(a[m], a0 + 32 * (m * lda + ks));
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          if (jp < np) {
            uint32_t b[4];
            ldmatrix_x4(b, b0 + 32 * (ks + jp * ldw));
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              mma_bf16(acc[m][2 * jp], a[m], b[0], b[1]);
              mma_bf16(acc[m][2 * jp + 1], a[m], b[2], b[3]);
            }
          }
        }
      }
    }
  }
}

// acc += A B for one m16 row tile whose A-fragments are in registers
// (a[kk] for k16 step kk < nk, e.g. a previous product's C fragments packed
// to bf16x2: see mma.cuh), B [16 nk, 16 np] at (0, bn0) in shared memory.
template <int KT, int NT>
__device__ __forceinline__ void mma_regs(float (&acc)[1][NT][4], const uint32_t (&a)[KT][4],
                                         const __nv_bfloat16* B, int ldb, int bn0, int nk,
                                         int np) {
  const uint32_t b0 = b16_addr(B, ldb, 0, bn0);
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    if (kk < nk) {
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        if (jp < np) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, b0 + 32 * (kk * ldb + jp));
          mma_bf16(acc[0][2 * jp], a[kk], b[0], b[1]);
          mma_bf16(acc[0][2 * jp + 1], a[kk], b[2], b[3]);
        }
      }
    }
  }
}

// Sum over the 4 lanes of a fragment row (the lanes that share g).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Sum over the 8 row groups g of a fragment column (lanes that share t4),
// the same bits in all of them.
__device__ __forceinline__ float rows_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// Max over the 8 row groups g of a fragment column (lanes that share t4).
__device__ __forceinline__ float rows_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
}

// Min over the 8 row groups g of a fragment column, of row indices.
__device__ __forceinline__ int rows_min(int v) {
  v = min(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = min(v, __shfl_xor_sync(0xffffffffu, v, 8));
  return min(v, __shfl_xor_sync(0xffffffffu, v, 16));
}

}  // namespace psam
