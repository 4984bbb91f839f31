// K7: backward of the fused PointNet patch encoder K2.
//
// Replaces point_sam_tpu/ops/patch_encoder_pallas.py::patch_encoder_fused_bwd
// (_bwd_kernel). Per patch of K grouped points it takes K2's saved
// max-pools (pool = max over K of a2, and the first argmax rows arg2 of a2
// and arg4 of a4), recomputes the forward as K2 does (stage 1 Dense -> LN
// -> GELU -> Dense, the pooled / pointwise split of the stage-2 Dense,
// LN -> GELU), then runs the reference's backward chain:
//   da4 = first-max pool backward of dout (rows arg4)   dw2b, db2b
//   dg3 = da4c w2b^T -> GELU' -> LN backward        ds2, dt2, da3
//   dw2a = [pool^T sum_K da3 ; a2^T da3], db2a
//   da2 = da3 w2x^T + first-max pool backward of (sum_K da3) w2p^T (rows arg2)
//   dw1b, db1b; dg1 = da2c w1b^T -> GELU' -> LN backward -> ds1, dt1, da1
//   dw1a, db1a; dx = da1 w1a^T (only when asked for)
// with matmul operands rounded to the compute dtype where the reference
// rounds them (da4c, da3, da2c, da1), fp32 accumulation, and every
// max-pool gradient routed to the FIRST maximal row of its column.
//
// Where the argmaxes come from: K2's forward computes both max-pools
// anyway, so it keeps each column's first maximal row (B*G*(h0 + cout)
// int32, 6 MB at the train shapes) and the autograd Function saves them.
// Finding them here again took two more passes over every patch (stage 1
// for a2's max, then stage 1, stage 2 and the widest product, g3 w2b, for
// a4's only): about half of this kernel's tensor work. K2's a2 and a4 come
// from mma.sync in another summation order than the recompute here, so the
// pooled gradients go to K2's rows and the values at those rows are
// recomputed here: the reference's arithmetic up to rounding.
//
// What bounds it on the H100: like K2, the [G*K, 512] hidden activations
// (0.5-1 GB per tensor at the train shapes) must not go through device
// memory, so they are recomputed on chip. The one exception is the
// stage-1 output gradient da2 (fp32 [rows, h0], 0.27-0.54 GB at the train
// shapes): it needs the whole patch's sum of da3 before it is complete, so
// it goes to a workspace and is read back once.
// Design: on the TPU the parameter grads add up over a sequential grid;
// here blocks run in no order. So each pass runs one persistent block per
// SM; block s walks the patches s, s + nblocks, ... in order and adds its
// parameter grads into its own fp32 workspace slice (no other block writes
// it), and a last launch adds the slices in slice order. No atomics on
// floats: the grads are the same from run to run.
// Per patch, two passes over its rows:
//   C: stage 1 + stage-2 up to GELU -> the stage-2 backward, da2's
//      pointwise part to the workspace; then the pooled branch;
//   D: stage 1 without its second Dense -> the stage-1 backward, dx.
// Two routes:
// - bf16 with h0 <= 128 and h0, h1, C_out multiples of 16 (K2's mma gate),
//   where the pass-C kernel's shared memory fits (K <= 256 at h(128, 512))
//   and C_in <= 160 at h0 = 128 (pass D's dw1a in registers): pass C on
//   patch_encoder_bwd_c_mma_kernel (mma.sync.m16n8k16 on 64-row chunks,
//   K2's stage 1 once per patch and cp.async weight ring; see the kernel's
//   comment), then pass D on patch_encoder_bwd_d_mma_kernel (mma.sync on
//   64-row chunks, resident weights, dw1b and dw1a in registers for the
//   block's life), a launch of its own over the same patches in the same
//   order, then the reduction.
// - otherwise (fp32, other widths, longer patches): both passes per patch
//   in patch_encoder_bwd_kernel. Products: in bf16 with widths that are
//   multiples of 16, every product with a wide operand runs on the tensor
//   cores (WMMA 16x16x16, fp32 accumulation): its operands are rounded to
//   bf16 anyway, so bf16 copies of them in shared memory make the products
//   exact up to summation order. The 16-row tile is one WMMA row tile; a
//   warp owns 16-column output tiles and reads its weight fragments from
//   L2. The weight-gradient products (a^T b over the tile's rows) add their
//   16x16 tiles straight into the block's workspace slice. The narrow
//   products (C_in columns), the sparse max-pool ones and the fp32 path run
//   as FMA loops.
#include <mma.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "mma_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kRows = 16;  // one WMMA row tile

__host__ __device__ __forceinline__ int pad8(int n) { return (n + 7) & ~7; }

template <typename T>
struct Params {
  const T* x;     // [B, G*K, cin]
  const T* dout;  // [B, G, cout]
  // K2's saved max-pools: pool [B, G, h0] (max over K of a2), arg2 [B, G,
  // h0] and arg4 [B, G, cout], their first argmax rows.
  const T* pool; const int* arg2; const int* arg4;
  const T* w1a; const float* b1a; const float* s1; const float* t1;
  const T* w1b; const float* b1b;
  const T* w2a; const float* b2a; const float* s2; const float* t2;
  // Transposed copies [out, in]: w1a^T [h0, cin], w1b^T [h0, h0],
  // w2a[:h0]^T [h1, h0], w2a[h0:]^T [h1, h0], w2b^T [cout, h1].
  const T* w1aT; const T* w1bT; const T* w2pT; const T* w2xT; const T* w2bT;
  T* dx;         // [B, G*K, cin] or null
  float* da2;    // fp32 workspace [B*G*K, h0]
  float* work;   // fp32 [nslices, total]: one slice per block
  int npatch, K, cin, h0, h1, cout, tanh_act;
  int tc;        // bf16 with h0, h1, cout multiples of 16: tensor cores
};

// Offsets of the 12 parameter grads in a slice, in the parameters' order;
// dw2b is kept transposed ([cout, h1]) in the slices so that a block's
// column updates are coalesced, and put back by the reduction.
struct GradOffsets {
  int w1a, b1a, s1, t1, w1b, b1b, w2a, b2a, s2, t2, w2b, b2b, total;
  __host__ __device__ GradOffsets(int cin, int h0, int h1, int cout) {
    int off = 0;
    auto take = [&](int n) { const int at = off; off += n; return at; };
    w1a = take(cin * h0); b1a = take(h0); s1 = take(h0); t1 = take(h0);
    w1b = take(h0 * h0); b1b = take(h0);
    w2a = take(2 * h0 * h1); b2a = take(h1); s2 = take(h1); t2 = take(h1);
    w2b = take(h1 * cout); b2b = take(cout);
    total = off;
  }
};

// Shared-memory layout in floats; every buffer starts 32-byte aligned.
struct Layout {
  int ldx, ldt, ldb0, ldb1;  // ldb0 / ldb1: row strides of the bf16 copies
  int xs, a1, g1, a2, a3, g3, t3, m1, inv1, m3, inv3;
  int g1b, a2b, d2b, d3b;  // bf16 copies of the product operands
  int pool, arg2, up_pool, arg4, dov, d3, dpool;
  int cstart, corder;  // the columns sorted by their a4 argmax row
  int vb1a, vs1, vt1, vb1b, vb2a, vs2, vt2, vb2b, total;
  __host__ __device__ Layout(int cin, int h0, int h1, int cout, int K) {
    ldx = pad8(cin);
    ldt = pad8(h1 > h0 ? h1 : h0);
    ldb0 = pad8(h0) + 8;  // +8 against shared-memory bank conflicts
    ldb1 = pad8(h1) + 8;
    int off = 0;
    auto take = [&](int floats) { const int at = off; off += pad8(floats); return at; };
    xs = take(kRows * ldx);
    a1 = take(kRows * h0); g1 = take(kRows * h0); a2 = take(kRows * h0);
    a3 = take(kRows * h1); g3 = take(kRows * h1); t3 = take(kRows * ldt);
    // a2b and d3b hold two tiles (slots), so that pass C adds a^T b into the
    // workspace once per two tiles.
    g1b = take(kRows * ldb0 / 2); a2b = take(kRows * ldb0); d2b = take(kRows * ldb0 / 2);
    d3b = take(kRows * ldb1);
    m1 = take(kRows); inv1 = take(kRows); m3 = take(kRows); inv3 = take(kRows);
    pool = take(h0); arg2 = take(h0); up_pool = take(h1);
    arg4 = take(cout); dov = take(cout); d3 = take(h1); dpool = take(h0);
    cstart = take(K + 1); corder = take(cout);
    vb1a = take(h0); vs1 = take(h0); vt1 = take(h0); vb1b = take(h0);
    vb2a = take(h1); vs2 = take(h1); vt2 = take(h1); vb2b = take(cout);
    total = off;
  }
};

__device__ __forceinline__ float act_fwd(float y, bool tanh_act) {
  return tanh_act ? psam::gelu_tanh(y) : psam::gelu_erf(y);
}

// d/dy of the GELU at the fp32 LN output y (the reference's _act_grad).
__device__ __forceinline__ float act_grad(float y, bool tanh_act) {
  if (tanh_act) {
    const float y2 = y * y;
    const float t = tanhf(psam::kGeluC0 * (y + psam::kGeluC1 * y * y2));
    const float du = psam::kGeluC0 * (1.0f + 3.0f * psam::kGeluC1 * y2);
    return 0.5f * (1.0f + t) + 0.5f * y * (1.0f - t * t) * du;
  }
  const float cdf = 0.5f * (1.0f + erff(y * psam::kSqrtHalf));
  return cdf + y * expf(-0.5f * y * y) * 0.3989422804014327f;
}

// Per row of x [rows][ld] (width n): fp32 two-pass LN statistics, stored in
// mean / inv, and g = round(GELU(LN(x) * s + t)) into g [rows][ldg] (and
// its bf16 copy into gb when not null).
template <typename T>
__device__ void ln_act_rows(const float* x, int ld, int rows, int n, const float* s,
                            const float* t, bool tanh_act, float* g, int ldg, float* mean,
                            float* inv, bf16* gb, int ldgb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += nwarps) {
    const float* row = x + r * ld;
    float sum = 0.0f;
    for (int i = lane; i < n; i += 32) sum += row[i];
    const float m = psam::warp_sum(sum) / n;
    float q = 0.0f;
    for (int i = lane; i < n; i += 32) {
      const float c = row[i] - m;
      q += c * c;
    }
    const float iv = rsqrtf(psam::warp_sum(q) / n + 1e-5f);
    for (int i = lane; i < n; i += 32) {
      const float v = psam::round_to<T>(act_fwd((row[i] - m) * iv * s[i] + t[i], tanh_act));
      g[r * ldg + i] = v;
      if (gb) gb[r * ldgb + i] = __float2bfloat16_rn(v);
    }
    if (lane == 0) {
      mean[r] = m;
      inv[r] = iv;
    }
  }
}

// In place on d [rows][ldd] (width n): dl = d * GELU'(LN output of a).
__device__ void mul_act_grad(float* d, int ldd, const float* a, int lda, int rows, int n,
                             const float* mean, const float* inv, const float* s,
                             const float* t, bool tanh_act) {
  for (int e = threadIdx.x; e < rows * n; e += blockDim.x) {
    const int r = e / n, i = e % n;
    const float y = (a[r * lda + i] - mean[r]) * inv[r] * s[i] + t[i];
    d[r * ldd + i] *= act_grad(y, tanh_act);
  }
}

// LN backward. Column pass: ds[i] += sum_r dl * xhat, dt[i] += sum_r dl over
// the nr valid rows; then, per row, dl is replaced in place by
// da = inv * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)), dxhat = dl s.
__device__ void ln_bwd_rows(float* dl, int ld, const float* a, int lda, int rows, int nr, int n,
                            const float* mean, const float* inv, const float* s, float* ds,
                            float* dt) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float vs = 0.0f, vt = 0.0f;
    for (int r = 0; r < nr; ++r) {
      const float g = dl[r * ld + i];
      vs = fmaf(g, (a[r * lda + i] - mean[r]) * inv[r], vs);
      vt += g;
    }
    ds[i] += vs;
    dt[i] += vt;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int r = warp; r < rows; r += nwarps) {
    float* row = dl + r * ld;
    const float* ar = a + r * lda;
    float s1 = 0.0f, s2 = 0.0f;
    for (int i = lane; i < n; i += 32) {
      const float dxh = row[i] * s[i];
      s1 += dxh;
      s2 += dxh * (ar[i] - mean[r]) * inv[r];
    }
    const float mu1 = psam::warp_sum(s1) / n, mu2 = psam::warp_sum(s2) / n;
    for (int i = lane; i < n; i += 32) {
      const float xh = (ar[i] - mean[r]) * inv[r];
      row[i] = inv[r] * (row[i] * s[i] - mu1 - xh * mu2);
    }
  }
}

// acc[i] += sum_r x[r][i] over the nr valid rows (one thread per column).
__device__ void col_sum(const float* x, int ld, int nr, int n, float* acc) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float v = 0.0f;
    for (int r = 0; r < nr; ++r) v += x[r * ld + i];
    acc[i] += v;
  }
}

// x = round(x) in place, and its bf16 copy into xb when not null.
template <typename T>
__device__ void round_rows(float* x, int ld, int rows, int n, bf16* xb, int ldb) {
  for (int e = threadIdx.x; e < rows * n; e += blockDim.x) {
    const int r = e / n, i = e % n;
    const float v = psam::round_to<T>(x[r * ld + i]);
    x[r * ld + i] = v;
    if (xb) xb[r * ldb + i] = __float2bfloat16_rn(v);
  }
}

// out[i * n + j] += sum_{r < nr} A[r][i] * Bm[r][j]: a weight-gradient
// product over the tile's rows, added into the block's workspace slice.
__device__ void tn_accum(const float* A, int lda, int m, const float* Bm, int ldb, int n, int nr,
                         float* __restrict__ out) {
  for (int e = threadIdx.x; e < m * n; e += blockDim.x) {
    const int i = e / n, j = e % n;
    float acc = 0.0f;
    for (int r = 0; r < nr; ++r) acc = fmaf(A[r * lda + i], Bm[r * ldb + j], acc);
    out[e] += acc;
  }
}

// C[16][n] (fp32, ldc) = A[16][k] (bf16 shared, lda) @ W[k][n] (bf16 global,
// row-major) on the tensor cores; k and n multiples of 16.
__device__ void tc_rows16(const bf16* A, int lda, int k, const bf16* __restrict__ W, int n,
                          float* C, int ldc) {
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int ct = warp; ct < n / 16; ct += nwarps) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kk = 0; kk < k; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, A + kk, lda);
      wmma::load_matrix_sync(b, W + (size_t)kk * n + ct * 16, n);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(C + ct * 16, acc, ldc, wmma::mem_row_major);
  }
}

// out[m][n] (fp32 global, row-major) += A[16 k][m]^T B[16 k][n] (bf16 shared)
// on the tensor cores, k = ``ksteps`` row tiles (rows past the valid ones
// hold zero gradients); m and n multiples of 16.
__device__ void tc_tn_accum(const bf16* A, int lda, int m, const bf16* B, int ldb, int n,
                            int ksteps, float* __restrict__ out) {
  using namespace nvcuda;
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int nt = n / 16;
  for (int t = warp; t < (m / 16) * nt; t += nwarps) {
    const int it = t / nt, jt = t % nt;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    float* o = out + (size_t)it * 16 * n + jt * 16;
    wmma::load_matrix_sync(c, o, n, wmma::mem_row_major);
    for (int kk = 0; kk < ksteps; ++kk) {
      wmma::load_matrix_sync(a, A + kk * 16 * lda + it * 16, lda);
      wmma::load_matrix_sync(b, B + kk * 16 * ldb + jt * 16, ldb);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(o, c, n, wmma::mem_row_major);
  }
}

// C = A @ W over the 16-row tile: tensor cores from the bf16 copy of A when
// ``tc`` (bf16 only), else the fp32 FMA loop from A itself.
template <typename T>
__device__ __forceinline__ void mm16(bool tc, const float* af, int ldaf, const bf16* ab, int ldab,
                                     int k, const T* W, int n, float* C, int ldc) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (tc) {
      tc_rows16(ab, ldab, k, W, n, C, ldc);
      return;
    }
  }
  psam::rows_matmul<T, kRows>(af, ldaf, k, W, n, C, ldc);
}

// out += A^T B over the tile's rows, on the tensor cores when ``tc``.
__device__ __forceinline__ void tn16(bool tc, const float* af, int ldaf, const bf16* ab, int ldab,
                                     int m, const float* bfp, int ldbf, const bf16* bb, int ldbb,
                                     int n, int nr, float* out) {
  if (tc)
    tc_tn_accum(ab, ldab, m, bb, ldbb, n, 1, out);
  else
    tn_accum(af, ldaf, m, bfp, ldbf, n, nr, out);
}

// Stage 1 on rows [r0, r0 + nr) of a patch: x -> a1 (Dense, rounded) ->
// stats + g1 -> a2 (Dense, rounded) when ``with_a2``.
template <typename T>
__device__ void stage1(const Params<T>& p, const T* __restrict__ xpatch, int r0, int nr,
                       float* sm, const Layout& L, bool with_a2, bf16* a2b) {
  using namespace psam;
  float* xs = sm + L.xs;
  for (int e = threadIdx.x; e < kRows * L.ldx; e += blockDim.x) {
    const int r = e / L.ldx, c = e % L.ldx;
    xs[e] = (r < nr && c < p.cin) ? to_f32<T>(xpatch[(size_t)(r0 + r) * p.cin + c]) : 0.0f;
  }
  __syncthreads();
  rows_matmul<T, kRows>(xs, L.ldx, p.cin, p.w1a, p.h0, sm + L.a1, p.h0);
  __syncthreads();
  rows_epilogue<T>(sm + L.a1, p.h0, kRows, p.h0, nullptr, p.b1a, nullptr, nullptr, false,
                   nullptr, 0);
  __syncthreads();
  const bool tc = p.tc != 0;
  bf16* g1b = reinterpret_cast<bf16*>(sm + L.g1b);
  ln_act_rows<T>(sm + L.a1, p.h0, kRows, p.h0, p.s1, p.t1, p.tanh_act != 0, sm + L.g1, p.h0,
                 sm + L.m1, sm + L.inv1, tc ? g1b : nullptr, L.ldb0);
  __syncthreads();
  if (!with_a2) return;
  mm16<T>(tc, sm + L.g1, p.h0, g1b, L.ldb0, p.h0, p.w1b, p.h0, sm + L.a2, p.h0);
  __syncthreads();
  rows_epilogue<T>(sm + L.a2, p.h0, kRows, p.h0, nullptr, p.b1b, nullptr, nullptr, false,
                   tc ? a2b : nullptr, L.ldb0);
  __syncthreads();
}

// Stage 2 up to the GELU on the tile's a2: a3 = round(round(a2 @ w2x +
// up_pool) + round(b2a)), its LN statistics, g3 = round(GELU(LN(a3))).
template <typename T>
__device__ void stage2_act(const Params<T>& p, float* sm, const Layout& L, const bf16* a2b) {
  using namespace psam;
  const bool tc = p.tc != 0;
  mm16<T>(tc, sm + L.a2, p.h0, a2b, L.ldb0, p.h0,
          p.w2a + (size_t)p.h0 * p.h1, p.h1, sm + L.a3, p.h1);
  __syncthreads();
  rows_epilogue<T>(sm + L.a3, p.h1, kRows, p.h1, sm + L.up_pool, p.b2a, nullptr, nullptr, false,
                   nullptr, 0);
  __syncthreads();
  ln_act_rows<T>(sm + L.a3, p.h1, kRows, p.h1, p.s2, p.t2, p.tanh_act != 0, sm + L.g3, p.h1,
                 sm + L.m3, sm + L.inv3, nullptr, 0);
  __syncthreads();
}

// Per patch: K2's max-pools and argmaxes, dout, up_pool = pool @ w2a[:h0],
// the columns in order of their argmax row, and d3 = 0.
template <typename T>
__device__ __forceinline__ void load_patch(const Params<T>& p, int pi, float* sm, const Layout& L) {
  using namespace psam;
  const int h0 = p.h0, h1 = p.h1, cout = p.cout, K = p.K;
  float* pool = sm + L.pool;
  int* arg2 = reinterpret_cast<int*>(sm + L.arg2);
  int* arg4 = reinterpret_cast<int*>(sm + L.arg4);
  int* cstart = reinterpret_cast<int*>(sm + L.cstart);
  int* corder = reinterpret_cast<int*>(sm + L.corder);
  for (int i = threadIdx.x; i < h0; i += blockDim.x) {
    pool[i] = to_f32<T>(p.pool[(size_t)pi * h0 + i]);
    arg2[i] = p.arg2[(size_t)pi * h0 + i];
  }
  for (int c = threadIdx.x; c < cout; c += blockDim.x) {
    arg4[c] = p.arg4[(size_t)pi * cout + c];
    sm[L.dov + c] = to_f32<T>(p.dout[(size_t)pi * cout + c]);
  }
  for (int j = threadIdx.x; j < h1; j += blockDim.x) sm[L.d3 + j] = 0.0f;
  __syncthreads();
  rows_matmul<T, 1>(pool, h0, h0, p.w2a, h1, sm + L.up_pool, h1);
  __syncthreads();

  // The columns in order of their argmax row (and of c within a row), so
  // that a tile visits only its own columns. One thread: the order, and so
  // every sum below, is the same from run to run.
  if (threadIdx.x == 0) {
    for (int r = 0; r <= K; ++r) cstart[r] = 0;
    for (int c = 0; c < cout; ++c) ++cstart[arg4[c] + 1];
    for (int r = 0; r < K; ++r) cstart[r + 1] += cstart[r];
    for (int c = 0; c < cout; ++c) corder[cstart[arg4[c]]++] = c;
    for (int r = K; r > 0; --r) cstart[r] = cstart[r - 1];
    cstart[0] = 0;
  }
  __syncthreads();
}

// Pass C on patch pi (after load_patch): the stage-2 backward, da2's
// pointwise part to the workspace, then the pooled branch.
template <typename T>
__device__ __forceinline__ void pass_c(const Params<T>& p, int pi, float* sm, const Layout& L,
                                       const GradOffsets& O, float* work) {
  using namespace psam;
  const int h0 = p.h0, h1 = p.h1, K = p.K, ldt = L.ldt;
  const bool tanh_act = p.tanh_act != 0, tc = p.tc != 0;
  const T* xpatch = p.x + (size_t)pi * K * p.cin;
  float* da2 = p.da2 + (size_t)pi * K * h0;
  bf16* a2b = reinterpret_cast<bf16*>(sm + L.a2b);
  bf16* d3b = reinterpret_cast<bf16*>(sm + L.d3b);
  float* pool = sm + L.pool;
  int* arg2 = reinterpret_cast<int*>(sm + L.arg2);
  int* arg4 = reinterpret_cast<int*>(sm + L.arg4);
  float* dov = sm + L.dov;
  int* cstart = reinterpret_cast<int*>(sm + L.cstart);
  int* corder = reinterpret_cast<int*>(sm + L.corder);
  float* d3 = sm + L.d3;
  float* t3 = sm + L.t3;
  for (int r0 = 0; r0 < K; r0 += kRows) {
    const int nr = min(kRows, K - r0);
    const int slot = (r0 / kRows) & 1;  // this tile's half of a2b / d3b
    bf16* a2s = a2b + slot * kRows * L.ldb0;
    bf16* d3s = d3b + slot * kRows * L.ldb1;
    stage1<T>(p, xpatch, r0, nr, sm, L, true, a2s);
    stage2_act<T>(p, sm, L, a2s);
    // dg3[r] = sum over the columns c whose max is row r of dout_c w2b[:, c];
    // dw2b[:, c] += g3[r] dout_c (the slice holds dw2b^T). Loads are issued
    // several at a time, ahead of their uses.
    const int c0 = cstart[r0], ncols = cstart[r0 + nr] - c0;
    for (int e = threadIdx.x; e < kRows * h1; e += blockDim.x) t3[(e / h1) * ldt + e % h1] = 0.0f;
    __syncthreads();
    for (int j = threadIdx.x; j < h1; j += blockDim.x)
      for (int q0 = 0; q0 < ncols; q0 += 4) {
        float w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          w[u] = q0 + u < ncols ? to_f32<T>(p.w2bT[(size_t)corder[c0 + q0 + u] * h1 + j]) : 0.0f;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (q0 + u >= ncols) break;
          const int c = corder[c0 + q0 + u];
          float* d = t3 + (arg4[c] - r0) * ldt + j;
          *d = fmaf(round_to<T>(dov[c]), w[u], *d);
        }
      }
    for (int e0 = threadIdx.x; e0 < ncols * h1; e0 += 8 * blockDim.x) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * blockDim.x;
        v[u] = e < ncols * h1 ? work[O.w2b + (size_t)corder[c0 + e / h1] * h1 + e % h1] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e >= ncols * h1) break;
        const int c = corder[c0 + e / h1], j = e % h1;
        work[O.w2b + (size_t)c * h1 + j] =
            v[u] + sm[L.g3 + (arg4[c] - r0) * h1 + j] * round_to<T>(dov[c]);
      }
    }
    __syncthreads();
    mul_act_grad(t3, ldt, sm + L.a3, h1, kRows, h1, sm + L.m3, sm + L.inv3, p.s2, p.t2,
                 tanh_act);
    __syncthreads();
    ln_bwd_rows(t3, ldt, sm + L.a3, h1, kRows, nr, h1, sm + L.m3, sm + L.inv3, p.s2,
                sm + L.vs2, sm + L.vt2);
    __syncthreads();
    col_sum(t3, ldt, nr, h1, d3);  // sum_K da3 (fp32), also db2a
    __syncthreads();
    round_rows<T>(t3, ldt, kRows, h1, tc ? d3s : nullptr, L.ldb1);  // da3
    __syncthreads();
    float* dw2x = work + O.w2a + (size_t)h0 * h1;
    if (!tc)
      tn_accum(sm + L.a2, h0, h0, t3, ldt, h1, nr, dw2x);
    else if (slot == 1 || r0 + kRows >= K)  // both slots, or the last tile
      tc_tn_accum(a2b, L.ldb0, h0, d3b, L.ldb1, h1, slot + 1, dw2x);
    // da2's pointwise part da3 @ w2x^T, to the workspace.
    mm16<T>(tc, t3, ldt, d3s, L.ldb1, h1, p.w2xT, h0, sm + L.a1, h0);
    __syncthreads();
    for (int e = threadIdx.x; e < nr * h0; e += blockDim.x)
      da2[(size_t)r0 * h0 + e] = sm[L.a1 + e];
    __syncthreads();
  }
  // The pooled branch: d3c = round(sum_K da3); dw2a[:h0] += pool^T d3c;
  // dpool = d3c @ w2p^T goes to the first maximal row of each column.
  for (int j = threadIdx.x; j < h1; j += blockDim.x) {
    sm[L.vb2a + j] += d3[j];
    d3[j] = round_to<T>(d3[j]);
  }
  for (int c = threadIdx.x; c < p.cout; c += blockDim.x) sm[L.vb2b + c] += dov[c];
  __syncthreads();
  for (int e = threadIdx.x; e < h0 * h1; e += blockDim.x)
    work[O.w2a + e] += pool[e / h1] * d3[e % h1];
  rows_matmul<T, 1>(d3, h1, h1, p.w2pT, h0, sm + L.dpool, h0);
  __syncthreads();
  for (int i = threadIdx.x; i < h0; i += blockDim.x)
    da2[(size_t)arg2[i] * h0 + i] += sm[L.dpool + i];
  __syncthreads();
}

// Pass D on patch pi, from the finished da2: the stage-1 backward, dx.
template <typename T>
__device__ __forceinline__ void pass_d(const Params<T>& p, int pi, float* sm, const Layout& L,
                                       const GradOffsets& O, float* work) {
  using namespace psam;
  const int h0 = p.h0, K = p.K, ldt = L.ldt;
  const bool tanh_act = p.tanh_act != 0, tc = p.tc != 0;
  const T* xpatch = p.x + (size_t)pi * K * p.cin;
  const float* da2 = p.da2 + (size_t)pi * K * h0;
  bf16* a2b = reinterpret_cast<bf16*>(sm + L.a2b);
  bf16* g1b = reinterpret_cast<bf16*>(sm + L.g1b);
  bf16* d2b = reinterpret_cast<bf16*>(sm + L.d2b);
  float* t3 = sm + L.t3;
  for (int r0 = 0; r0 < K; r0 += kRows) {
    const int nr = min(kRows, K - r0);
    stage1<T>(p, xpatch, r0, nr, sm, L, false, a2b);
    float* d2 = sm + L.a2;
    for (int e = threadIdx.x; e < kRows * h0; e += blockDim.x)
      d2[e] = e < nr * h0 ? da2[(size_t)r0 * h0 + e] : 0.0f;
    __syncthreads();
    col_sum(d2, h0, nr, h0, sm + L.vb1b);
    __syncthreads();
    round_rows<T>(d2, h0, kRows, h0, tc ? d2b : nullptr, L.ldb0);  // da2c
    __syncthreads();
    tn16(tc, sm + L.g1, h0, g1b, L.ldb0, h0, d2, h0, d2b, L.ldb0, h0, nr, work + O.w1b);
    mm16<T>(tc, d2, h0, d2b, L.ldb0, h0, p.w1bT, h0, t3, ldt);  // dg1
    __syncthreads();
    mul_act_grad(t3, ldt, sm + L.a1, h0, kRows, h0, sm + L.m1, sm + L.inv1, p.s1, p.t1,
                 tanh_act);
    __syncthreads();
    ln_bwd_rows(t3, ldt, sm + L.a1, h0, kRows, nr, h0, sm + L.m1, sm + L.inv1, p.s1,
                sm + L.vs1, sm + L.vt1);
    __syncthreads();
    col_sum(t3, ldt, nr, h0, sm + L.vb1a);
    __syncthreads();
    round_rows<T>(t3, ldt, kRows, h0, nullptr, 0);  // da1
    __syncthreads();
    tn_accum(sm + L.xs, L.ldx, p.cin, t3, ldt, h0, nr, work + O.w1a);
    if (p.dx) {
      rows_matmul<T, kRows>(t3, ldt, h0, p.w1aT, p.cin, sm + L.g1, p.cin);
      __syncthreads();
      T* dxp = p.dx + (size_t)pi * K * p.cin;
      for (int e = threadIdx.x; e < nr * p.cin; e += blockDim.x)
        dxp[(size_t)r0 * p.cin + e] = from_f32<T>(sm[L.g1 + e]);
    }
    __syncthreads();
  }
}

// The block's vector-grad sums (vb1a .. vb2b) into its slice.
__device__ __forceinline__ void add_vector_sums(float* work, const GradOffsets& O,
                                                const float* sm, const Layout& L, int h0, int h1,
                                                int cout) {
  __syncthreads();
  for (int i = threadIdx.x; i < h0; i += blockDim.x) {
    work[O.b1a + i] += sm[L.vb1a + i];
    work[O.s1 + i] += sm[L.vs1 + i];
    work[O.t1 + i] += sm[L.vt1 + i];
    work[O.b1b + i] += sm[L.vb1b + i];
  }
  for (int j = threadIdx.x; j < h1; j += blockDim.x) {
    work[O.b2a + j] += sm[L.vb2a + j];
    work[O.s2 + j] += sm[L.vs2 + j];
    work[O.t2 + j] += sm[L.vt2 + j];
  }
  for (int c = threadIdx.x; c < cout; c += blockDim.x) work[O.b2b + c] += sm[L.vb2b + c];
}

// Passes C and D per patch in one launch (fp32, and bf16 outside the mma
// route's gate).
template <typename T>
__global__ void __launch_bounds__(kThreads) patch_encoder_bwd_kernel(Params<T> p) {
  extern __shared__ __align__(128) float sm[];
  const Layout L(p.cin, p.h0, p.h1, p.cout, p.K);
  const GradOffsets O(p.cin, p.h0, p.h1, p.cout);
  float* work = p.work + (size_t)blockIdx.x * O.total;
  for (int e = threadIdx.x; e < 4 * pad8(p.h0) + 3 * pad8(p.h1) + pad8(p.cout); e += blockDim.x)
    sm[L.vb1a + e] = 0.0f;  // the block's vector-grad sums (vb1a .. vb2b)
  for (int pi = blockIdx.x; pi < p.npatch; pi += gridDim.x) {
    load_patch<T>(p, pi, sm, L);
    pass_c<T>(p, pi, sm, L, O, work);
    pass_d<T>(p, pi, sm, L, O, work);
  }
  add_vector_sums(work, O, sm, L, p.h0, p.h1, p.cout);
}

// ------------------------------------------------- bf16 pass C on mma.sync
constexpr int kMmaWarps = 16;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kChunk = 64;   // rows a chunk: 2 row groups of 32
constexpr int kSlabK = 64;   // weight rows a slab: four k16 steps
constexpr int kSlabN = 256;  // columns a slice
constexpr int kGroupN = kSlabN / (kMmaWarps / 2);  // a warp's columns of a slice
constexpr int kNt2 = kGroupN / 8;                  // its n8 tiles
constexpr int kLdSlab = kSlabN + 8;
constexpr int kStages = 2;   // slabs in the ring
constexpr int kNt1 = 16;     // n8 tiles of a stage-1 row (h0 <= 128)
constexpr int kHalf = psam::kMaxPerLane / 2;  // a lane's columns of half a row (h1 <= 512)

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// Shared-memory layout of the pass-C kernel in bytes, every buffer 128-byte
// aligned. Stage 1's weights and input tiles, the chunk buffer and the
// patch's cross-warp sums share their bytes (region "R").
struct CLayout {
  int kp, cinp, xslots, mwords;
  int a2, w1a, w1b, xw, ch, red, d3c, ring, up, vec, mask, pool, arg2, arg4, dov, xch, total;
  __host__ __device__ CLayout(int K, int cin, int h0, int h1, int cout) {
    kp = round_up(K, kChunk);
    cinp = round_up(cin, 16);
    const int cap = 20480 / (32 * (cinp + 8));  // <= 20 KB of input tiles, as K2
    xslots = imin(imin(kMmaWarps, kp / 16), cap > 1 ? cap : 1);
    mwords = (cout + 31) / 32;
    int off = 0;
    auto take = [&](int bytes) {
      const int at = off;
      off += (bytes + 127) & ~127;
      return at;
    };
    auto later = [](int a, int b) { return a > b ? a : b; };
    a2 = take(kp * (h0 + 8) * 2);
    const int shared_at = off;
    w1a = take(cinp * (h0 + 8) * 2);
    w1b = take(h0 * (h0 + 8) * 2);
    xw = take(xslots * 16 * (cinp + 8) * 2);
    int end = off;
    off = shared_at;
    ch = take(kChunk * (h1 + 8) * 2);
    end = later(end, off);
    off = shared_at;
    red = take((kMmaWarps / 2) * h1 * 4);
    d3c = take(h1 * 4);
    off = later(end, off);
    ring = take(kStages * kSlabK * kLdSlab * 2);
    up = take(h1 * 4);
    vec = take((4 * h0 + 3 * h1) * 4);
    mask = take(kChunk * mwords * 4);
    pool = take(h0 * 4);
    arg2 = take(h0 * 4);
    arg4 = take(cout * 4);
    dov = take(cout * 4);
    xch = take(kMmaWarps * 4 * 4);
    total = off;
  }
};

// The sum of v over the two warps of a row-epilogue pair (warps 2 q, 2 q
// + 1, pair barrier ``bar``), the same bits in both: each warp's warp_sum
// goes to its half of slot ``s`` of the pair's exchange words, the pair
// syncs, both add half 0's and half 1's. A slot is written again only after
// two more of the pair's syncs, when the partner has read it.
__device__ __forceinline__ float pair_sum(float v, float* xch, int s, int half, int bar) {
  float* const slot = xch + (bar - 1) * 8 + s;
  v = psam::warp_sum(v);
  if ((threadIdx.x & 31) == 0) slot[4 * half] = v;
  asm volatile("bar.sync %0, 64;\n" ::"r"(bar) : "memory");
  return slot[0] + slot[4];
}

// pair_sum of two values at once (slots 2 and 3).
__device__ __forceinline__ float2 pair_sum2(float a, float b, float* xch, int half, int bar) {
  float* const slot = xch + (bar - 1) * 8 + 2;
  a = psam::warp_sum(a);
  b = psam::warp_sum(b);
  if ((threadIdx.x & 31) == 0) {
    slot[4 * half] = a;
    slot[4 * half + 1] = b;
  }
  asm volatile("bar.sync %0, 64;\n" ::"r"(bar) : "memory");
  return make_float2(slot[0] + slot[4], slot[1] + slot[5]);
}

// Column pairs (n16) of a warp's column group starting at wc below n.
__device__ __forceinline__ int group_pairs(int n, int wc) {
  return min(kNt2 / 2, max(0, (n - wc) / 16));
}

// Pass C (and the pooled branch) in bf16 on mma.sync.m16n8k16, one
// persistent block of 16 warps per SM walking the patches s, s + nblocks,
// ... in order (as patch_encoder_bwd_kernel), per patch:
//  - up_pool = pool @ w2a[:h0] (one FMA column a thread), then stage 1 once
//    for the whole patch as K2 computes it (a warp per 16-row tile, LN ->
//    GELU on the fragments, packed C-to-A into the second Dense) into the
//    resident bf16 a2 [K, h0] (exact: the reference rounds it to bf16), with
//    the backward's activation (the LN affine in fp32, as the reference's
//    _bwd_kernel recomputes it);
//  - per 64-row chunk (two row groups of 32):
//    a3 = round(round(a2 w2x + up_pool) + round(b2a)) from slabs of w2x
//      through the ring; the epilogue on the fragments writes a3 in bf16
//      (exact) to the chunk buffer. Warp (rg, cg) owns rows 32 rg.. and
//      columns 32 cg.. of each 256-column slice;
//    the row epilogue, two warps per row (each half of its columns, a lane
//      holding 8 of them in registers; the row sums add the two warps' warp
//      sums through shared memory under a barrier of the pair): LN
//      statistics (fp32, two-pass); at the row's argmax columns (a bit mask
//      per row, built per chunk by integer atomicOr, walked in increasing c:
//      the old kernel's corder order) g3 for dw2b^T += g3 dout_c (each
//      (c, j) by one thread once a patch) and dg3 = sum_c dout_c w2b[:, c];
//      GELU', the LN backward, da3 rounded to bf16 in place of a3. The
//      column sums ds2, dt2 and sum_K da3 stay per warp and lane in
//      registers and go through shared memory once per patch (sum_K da3) or
//      per block (ds2, dt2), added over the pairs in pair order;
//    dw2x += a2^T da3 over the chunk: A-fragments of a2^T by ldmatrix.trans
//      from the resident a2, 16 x 64 warp tiles added into the block's fp32
//      slice (a read-modify-write per 64 rows);
//    da2 = da3 w2x^T from slabs of w2xT through the same ring, to the fp32
//      da2 workspace (stored evict-first: pass D reads it after the launch);
//  - then d3c = round(sum_K da3): dw2a[:h0] += pool^T d3c, dpool = d3c w2p^T
//    (a warp per row of w2p), added at the arg2 rows of da2.
// The ring carries 64-row x 256-column slabs of w2x then w2xT per chunk, two
// slots, 16-byte cp.async issued one slab ahead across chunk and patch
// boundaries, one barrier per slab (K2's ring).
// Shared memory at K = 256, h(128, 512) -> 512: 223,488 bytes (a2 68 KB;
// R 65 KB, the chunk buffer [64, h1 + 8] bf16, holding a3 then da3; the
// ring 66 KB; vectors, row masks, pool, argmaxes and the pairs' exchange
// words 18 KB): one block per SM. A patch longer than K = 256 at these
// widths does not fit (17 KB more per 64 rows); the route's gate sends it
// to patch_encoder_bwd_kernel.
// Measured on the card (PERF.md): two warps a row beat one (the column sums'
// registers spilled); spreading the dw2b^T columns over the warps, L2
// eviction hints on the slice and red.global adds for dw2x did not help:
// the slice's read-modify-writes (dw2x each chunk, dw2b^T and dw2a[:h0]
// each patch) move more bytes than anything else here.
__global__ void __launch_bounds__(kMmaThreads, 1) patch_encoder_bwd_c_mma_kernel(Params<bf16> p) {
  using namespace psam;
  extern __shared__ __align__(128) float smem[];
  unsigned char* const base = reinterpret_cast<unsigned char*>(smem);
  const CLayout L(p.K, p.cin, p.h0, p.h1, p.cout);
  const GradOffsets O(p.cin, p.h0, p.h1, p.cout);
  const int K = p.K, cin = p.cin, cinp = L.cinp, h0 = p.h0, h1 = p.h1, cout = p.cout;
  const int mwords = L.mwords, npair = h1 / 2;
  const bool tanh_act = p.tanh_act != 0;
  bf16* const a2 = reinterpret_cast<bf16*>(base + L.a2);
  bf16* const w1a = reinterpret_cast<bf16*>(base + L.w1a);
  bf16* const w1b = reinterpret_cast<bf16*>(base + L.w1b);
  bf16* const xw = reinterpret_cast<bf16*>(base + L.xw);
  bf16* const ch = reinterpret_cast<bf16*>(base + L.ch);
  float* const red = reinterpret_cast<float*>(base + L.red);
  float* const d3c = reinterpret_cast<float*>(base + L.d3c);
  bf16* const ring = reinterpret_cast<bf16*>(base + L.ring);
  float* const up = reinterpret_cast<float*>(base + L.up);
  uint32_t* const mask = reinterpret_cast<uint32_t*>(base + L.mask);
  float* const pool = reinterpret_cast<float*>(base + L.pool);
  int* const arg2 = reinterpret_cast<int*>(base + L.arg2);
  int* const arg4 = reinterpret_cast<int*>(base + L.arg4);
  float* const dov = reinterpret_cast<float*>(base + L.dov);
  float* const xch = reinterpret_cast<float*>(base + L.xch);
  // The per-column vectors, biases already rounded to bf16.
  float* const b1a = reinterpret_cast<float*>(base + L.vec);
  float* const s1 = b1a + h0;
  float* const t1 = s1 + h0;
  float* const b1b = t1 + h0;
  float* const b2a = b1b + h0;
  float* const s2 = b2a + h1;
  float* const t2 = s2 + h1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, rg = warp & 1, cg = warp >> 1;
  const int lda = h0 + 8, ldc = h1 + 8, ldx = cinp + 8;
  float* const work = p.work + (size_t)blockIdx.x * O.total;
  float* const dw2x = work + O.w2a + (size_t)h0 * h1;
  const bf16 zero = __float2bfloat16_rn(0.0f);

  // The ring's slabs in the order of use, per chunk: w2x = w2a[h0:] (a3) by
  // kSlabN-column slices of kSlabK-row slabs, then w2xT (da2, h0 <= 128
  // columns: one slice). Slab s goes to ring slot s % kStages, kStages - 1
  // slabs ahead of its use; the sequence runs on over the block's chunks.
  const int kh0 = (h0 + kSlabK - 1) / kSlabK, kh1 = (h1 + kSlabK - 1) / kSlabK;
  const int nh1 = (h1 + kSlabN - 1) / kSlabN, n_a = nh1 * kh0, per_chunk = n_a + kh1;
  const int my_patches = (p.npatch - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int n_slabs = my_patches * (L.kp / kChunk) * per_chunk;
  // Thread tid copies the 16-byte chunks (rows cr + i kCopyStride, columns
  // cc..cc + 7) of each slab; entries past the weight's edge are zeroed.
  constexpr int kChunksN = kSlabN / 8, kCopyStride = kMmaThreads / kChunksN;
  static_assert(kMmaThreads % kChunksN == 0 && kSlabK % kCopyStride == 0, "slab copy");
  const int cr = tid / kChunksN, cc = (tid % kChunksN) * 8;
  const uint32_t ring_at = smem_u32(ring + cr * kLdSlab + cc);
  int is = 0;
  auto issue = [&]() {
    if (is < n_slabs) {
      const int q = is % per_chunk;
      const bool tr = q >= n_a;
      const bf16* W = tr ? p.w2xT : p.w2a + (size_t)h0 * h1;
      const int kdim = tr ? h1 : h0, n = tr ? h0 : h1;
      const int k0 = (tr ? q - n_a : q % kh0) * kSlabK + cr, n0 = (tr ? 0 : q / kh0) * kSlabN + cc;
      const bf16* src = W + (size_t)k0 * n + n0;
      const uint32_t dst = ring_at + (is % kStages) * (kSlabK * kLdSlab * 2);
#pragma unroll
      for (int i = 0; i < kSlabK / kCopyStride; ++i) {
        const bool in = n0 < n && k0 + i * kCopyStride < kdim;
        cp_async16(dst + i * (kCopyStride * kLdSlab * 2),
                   in ? src + (size_t)i * kCopyStride * n : W, in);
      }
    }
    cp_async_commit();
    ++is;
  };
  int s = 0;
  auto next_slab = [&]() {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue();
    return ring + (s++ % kStages) * kSlabK * kLdSlab;
  };
  constexpr int kSteps = kSlabK / 16;

  for (int i = 0; i < kStages - 1; ++i) issue();
  for (int i = tid; i < h0; i += kMmaThreads) {
    b1a[i] = round_to<bf16>(p.b1a[i]);
    s1[i] = p.s1[i];
    t1[i] = p.t1[i];
    b1b[i] = round_to<bf16>(p.b1b[i]);
  }
  for (int i = tid; i < h1; i += kMmaThreads) {
    b2a[i] = round_to<bf16>(p.b2a[i]);
    s2[i] = p.s2[i];
    t2[i] = p.t2[i];
  }
  for (int i = tid; i < kChunk * mwords; i += kMmaThreads) mask[i] = 0u;
  // The row epilogue's warp pair (rows), half (columns) and pair barrier.
  const int pair = warp >> 1, half = warp & 1, bar = 1 + pair;
  const int hpair = npair / 2, hoff = half * hpair;  // column pairs a half, its first
  // This lane's partial column sums over its pair's rows (columns 2 (hoff +
  // lane + 32 j) + e at [2 j + e]): ds2, dt2 over the block's patches,
  // sum_K da3 over the patch; and this thread's column of db2a / db2b.
  float ps[kHalf], pt[kHalf], pd[kHalf];
#pragma unroll
  for (int k = 0; k < kHalf; ++k) ps[k] = pt[k] = 0.0f;
  float vb2a = 0.0f, vb2b = 0.0f;

  for (int pi = blockIdx.x; pi < p.npatch; pi += gridDim.x) {
    const bf16* __restrict__ xpatch = p.x + (size_t)pi * K * cin;
    float* const da2 = p.da2 + (size_t)pi * K * h0;
    // R is free (the previous patch ended in a barrier): stage 1's weights.
    copy_tile_async(w1a, lda, p.w1a, h0, 0, cinp, cin, 0, h0, h0);
    copy_tile_async(w1b, lda, p.w1b, h0, 0, h0, h0, 0, h0, h0);
    cp_async_commit();
    for (int i = tid; i < L.xslots * 16 * ldx; i += kMmaThreads) xw[i] = zero;
    // K2's max-pools and their first argmaxes, and dout.
    for (int i = tid; i < h0; i += kMmaThreads) {
      pool[i] = __bfloat162float(p.pool[(size_t)pi * h0 + i]);
      arg2[i] = p.arg2[(size_t)pi * h0 + i];
    }
    for (int c = tid; c < cout; c += kMmaThreads) {
      arg4[c] = p.arg4[(size_t)pi * cout + c];
      dov[c] = __bfloat162float(p.dout[(size_t)pi * cout + c]);
      vb2b += dov[c];
    }
    __syncthreads();
    rows_matmul<bf16, 1>(pool, h0, h0, p.w2a, h1, up, h1);
    cp_async_wait<0>();  // W1a and W1b (and the ring's slab in flight) have landed
    __syncthreads();

    // Stage 1, once per patch: each warp takes 16-row tiles; the products run
    // on registers (the first Dense's output, after LN -> GELU, is packed
    // C-to-A into the second's operand) and a2 goes to shared memory in bf16.
    {
      const int nt1 = h0 / 8, np1 = h0 / 16;
      bf16* const xt = xw + warp * 16 * ldx;
      for (int t = warp; warp < L.xslots && t < L.kp / 16; t += L.xslots) {
        const int r0 = 16 * t;
        // The tile's 16 rows are contiguous in x: 4 coalesced loads a lane in
        // flight, then their stores (columns cin..cinp stay zero).
        for (int e0 = lane; e0 < 16 * cin; e0 += 128) {
          bf16 v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = e0 + 32 * u;
            v[u] = e < 16 * cin && r0 * cin + e < K * cin ? xpatch[(size_t)r0 * cin + e] : zero;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int e = e0 + 32 * u, r = e / cin;
            if (e < 16 * cin) xt[r * ldx + e - r * cin] = v[u];
          }
        }
        __syncwarp();
        float acc[1][kNt1][4];
        zero_acc(acc);
        mma_smem<1>(acc, xt, ldx, 0, 0, w1a, lda, 0, 0, cinp / 16, np1);
        // Dense rounding, then LN over rows g (h = 0) and g + 8 (h = 1), whose
        // values are spread over the 4 lanes of a quad: two-pass fp32 stats.
        float sum[2] = {0.0f, 0.0f}, sq[2] = {0.0f, 0.0f}, mean[2], inv[2];
#pragma unroll
        for (int j = 0; j < kNt1; ++j) {
          if (j >= nt1) continue;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float& v = acc[0][j][i];
            v = round_to<bf16>(round_to<bf16>(v) + b1a[8 * j + 2 * t4 + (i & 1)]);
            sum[i >> 1] += v;
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) mean[h] = quad_sum(sum[h]) / h0;
#pragma unroll
        for (int j = 0; j < kNt1; ++j) {
          if (j >= nt1) continue;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float d = acc[0][j][i] - mean[i >> 1];
            sq[i >> 1] += d * d;
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) inv[h] = rsqrtf(quad_sum(sq[h]) / h0 + 1e-5f);
        // GELU(LN) with the affine in fp32, packed C-to-A as it goes.
        uint32_t a1[kNt1 / 2][4];
#pragma unroll
        for (int kk = 0; kk < kNt1 / 2; ++kk) {
          float y[2][4] = {};
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int j = 2 * kk + q;
            if (j >= nt1) continue;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int col = 8 * j + 2 * t4 + (i & 1);
              y[q][i] = round_to<bf16>(act_fwd(
                  (acc[0][j][i] - mean[i >> 1]) * inv[i >> 1] * s1[col] + t1[col], tanh_act));
            }
          }
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            a1[kk][2 * q] = pack_bf16(y[q][0], y[q][1]);
            a1[kk][2 * q + 1] = pack_bf16(y[q][2], y[q][3]);
          }
        }
        // a2 = round(round(a1 W1b) + round(b1b)), 64 columns at a time.
#pragma unroll
        for (int c0 = 0; c0 < 8 * kNt1; c0 += 64) {
          if (c0 >= h0) continue;
          float acc2[1][8][4];
          zero_acc(acc2);
          mma_regs(acc2, a1, w1b, lda, c0, np1, min(4, (h0 - c0) / 16));
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = c0 + 8 * j + 2 * t4;
            if (c0 + 8 * j >= h0) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<__nv_bfloat162*>(a2 + (r0 + g + 8 * h) * lda + col) =
                  __floats2bfloat162_rn(
                      round_to<bf16>(round_to<bf16>(acc2[0][j][2 * h]) + b1b[col]),
                      round_to<bf16>(round_to<bf16>(acc2[0][j][2 * h + 1]) + b1b[col + 1]));
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < kHalf; ++k) pd[k] = 0.0f;
    for (int r0 = 0; r0 < L.kp; r0 += kChunk) {
      const int nr = imin(kChunk, K - r0);
      // a3 = round(round(a2 W2a[h0:] + up_pool) + round(b2a)) -> ch in bf16.
      for (int sl = 0; sl < nh1; ++sl) {
        const int wc = sl * kSlabN + kGroupN * cg;
        float acc[2][kNt2][4];
        zero_acc(acc);
        for (int kb = 0; kb < kh0; ++kb) {
          const bf16* slab = next_slab();
          mma_smem<kSteps>(acc, a2, lda, r0 + 32 * rg, kb * kSlabK, slab, kLdSlab, 0,
                           kGroupN * cg, min(kSteps, (h0 - kb * kSlabK) / 16), group_pairs(h1, wc));
        }
#pragma unroll
        for (int j = 0; j < kNt2; ++j) {
          const int col = wc + 8 * j + 2 * t4;
          if (col >= h1) continue;
          const float u0 = up[col], u1 = up[col + 1], c0 = b2a[col], c1 = b2a[col + 1];
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = 32 * rg + 16 * m + g + 8 * h;
              *reinterpret_cast<__nv_bfloat162*>(ch + r * ldc + col) = __floats2bfloat162_rn(
                  round_to<bf16>(round_to<bf16>(acc[m][j][2 * h] + u0) + c0),
                  round_to<bf16>(round_to<bf16>(acc[m][j][2 * h + 1] + u1) + c1));
            }
        }
      }
      // The chunk's row masks: bit c of row r when column c's max is row
      // r0 + r. The masks were zeroed before the last slab barrier; integer
      // ORs give the same masks in any order.
      for (int c = tid; c < cout; c += kMmaThreads) {
        const int r = arg4[c] - r0;
        if (r >= 0 && r < nr) atomicOr(mask + r * mwords + (c >> 5), 1u << (c & 31));
      }
      __syncthreads();  // a3 and the masks are complete
      // The row epilogue: warps 2 q and 2 q + 1 take rows q, q + 8, ..., each
      // half of a row's columns, a lane holding the column pairs half * npair
      // / 2 + lane + 32 j in registers; the row sums add the two halves'
      // warp sums through shared memory (pair_sum).
      for (int r = pair; r < kChunk; r += kMmaWarps / 2) {
        __nv_bfloat162* const row = reinterpret_cast<__nv_bfloat162*>(ch + r * ldc) + hoff;
        if (r >= nr) {  // past the patch: zero da3
          for (int i = lane; i < hpair; i += 32) row[i] = __floats2bfloat162_rn(0.0f, 0.0f);
          continue;
        }
        float v[kHalf], d[kHalf];
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < kHalf / 2; ++j) {
          const int i = lane + 32 * j;
          const float2 f = i < hpair ? __bfloat1622float2(row[i]) : make_float2(0.0f, 0.0f);
          v[2 * j] = f.x;
          v[2 * j + 1] = f.y;
          d[2 * j] = d[2 * j + 1] = 0.0f;
          sum += f.x + f.y;
        }
        const float mean = pair_sum(sum, xch, 0, half, bar) / h1;
        float q = 0.0f;
#pragma unroll
        for (int j = 0; j < kHalf / 2; ++j) {
          if (lane + 32 * j >= hpair) continue;
          const float c0 = v[2 * j] - mean, c1 = v[2 * j + 1] - mean;
          q += c0 * c0 + c1 * c1;
        }
        const float inv = rsqrtf(pair_sum(q, xch, 1, half, bar) / h1 + 1e-5f);
        // The columns c whose max is this row, in increasing c: dg3 += dout_c
        // w2b[:, c] and dw2b^T[c] += g3 dout_c (each (c, j) by one thread once
        // a patch); a column's loads issued together, then its stores.
        const uint32_t* const mrow = mask + r * mwords;
        uint32_t any = 0u;
        for (int w = 0; w < mwords; ++w) any |= mrow[w];
        if (any) {
          uint32_t gp[kHalf / 2];  // g3 = round(GELU(LN(a3))), bf16 pairs (exact)
#pragma unroll
          for (int j = 0; j < kHalf / 2; ++j) {
            const int i = lane + 32 * j;
            if (i >= hpair) continue;
            const float2 sc = reinterpret_cast<const float2*>(s2 + 2 * hoff)[i];
            const float2 sh = reinterpret_cast<const float2*>(t2 + 2 * hoff)[i];
            gp[j] = pack_bf16(act_fwd((v[2 * j] - mean) * inv * sc.x + sh.x, tanh_act),
                              act_fwd((v[2 * j + 1] - mean) * inv * sc.y + sh.y, tanh_act));
          }
          for (int w = 0; w < mwords; ++w) {
            uint32_t bits = mrow[w];
            while (bits) {
              const int c = 32 * w + __ffs(bits) - 1;
              bits &= bits - 1;
              const float coef = dov[c];
              const __nv_bfloat162* const wr =
                  reinterpret_cast<const __nv_bfloat162*>(p.w2bT + (size_t)c * h1) + hoff;
              float2* const wk = reinterpret_cast<float2*>(work + O.w2b + (size_t)c * h1) + hoff;
              __nv_bfloat162 wv[kHalf / 2];
              float2 o[kHalf / 2];
#pragma unroll
              for (int j = 0; j < kHalf / 2; ++j) {
                const int i = lane + 32 * j;
                if (i >= hpair) continue;
                wv[j] = __ldg(wr + i);
                o[j] = wk[i];
              }
#pragma unroll
              for (int j = 0; j < kHalf / 2; ++j) {
                const int i = lane + 32 * j;
                if (i >= hpair) continue;
                const float2 f = __bfloat1622float2(wv[j]);
                d[2 * j] = fmaf(coef, f.x, d[2 * j]);
                d[2 * j + 1] = fmaf(coef, f.y, d[2 * j + 1]);
                // the bf16 pair unpacked: its bits are the float's top half
                o[j].x = fmaf(__uint_as_float(gp[j] << 16), coef, o[j].x);
                o[j].y = fmaf(__uint_as_float(gp[j] & 0xffff0000u), coef, o[j].y);
                wk[i] = o[j];
              }
            }
          }
        }
        // dl = dg3 GELU'(y), then the LN backward: da3 = inv (dl s - mean(dl
        // s) - xhat mean(dl s xhat)); ds2 += dl xhat, dt2 += dl.
        float m1 = 0.0f, m2 = 0.0f;
#pragma unroll
        for (int j = 0; j < kHalf / 2; ++j) {
          const int i = lane + 32 * j;
          if (i >= hpair) continue;
          const float2 sc = reinterpret_cast<const float2*>(s2 + 2 * hoff)[i];
          const float2 sh = reinterpret_cast<const float2*>(t2 + 2 * hoff)[i];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 2 * j + e;
            const float scale = e ? sc.y : sc.x, shift = e ? sh.y : sh.x;
            const float xh = (v[k] - mean) * inv;
            const float dl = d[k] * act_grad(xh * scale + shift, tanh_act);
            ps[k] = fmaf(dl, xh, ps[k]);
            pt[k] += dl;
            d[k] = dl * scale;
            m1 += d[k];
            m2 += d[k] * xh;
          }
        }
        const float2 mu = pair_sum2(m1, m2, xch, half, bar);
        const float mu1 = mu.x / h1, mu2 = mu.y / h1;
#pragma unroll
        for (int j = 0; j < kHalf / 2; ++j) {
          const int i = lane + 32 * j;
          if (i >= hpair) continue;
          float da[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 2 * j + e;
            da[e] = inv * (d[k] - mu1 - (v[k] - mean) * inv * mu2);
            pd[k] += da[e];
          }
          row[i] = __floats2bfloat162_rn(da[0], da[1]);  // da3, rounded
        }
      }
      __syncthreads();
      for (int i = tid; i < kChunk * mwords; i += kMmaThreads) mask[i] = 0u;

      // dw2x += a2^T da3 over the chunk's rows: 16 x 64 warp tiles, each
      // loaded from the block's slice, accumulated, stored back.
      {
        const int ntn = (h1 + 63) / 64, ntiles = (h0 / 16) * ntn;
        for (int t = warp; t < ntiles; t += kMmaWarps) {
          const int i0 = 16 * (t / ntn), n0 = 64 * (t % ntn);
          const int np = imin(4, (h1 - n0) / 16);
          float* const out = dw2x + (size_t)i0 * h1 + n0;
          float acc[1][8][4];
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float2 o = make_float2(0.0f, 0.0f);
              if (j < 2 * np) o = *reinterpret_cast<const float2*>(out + (size_t)(g + 8 * h) * h1 + 8 * j + 2 * t4);
              acc[0][j][2 * h] = o.x;
              acc[0][j][2 * h + 1] = o.y;
            }
          mma_smem_tn<kSteps>(acc, a2, lda, r0, i0, ch, ldc, 0, n0, kChunk / 16, np);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (j >= 2 * np) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<float2*>(out + (size_t)(g + 8 * h) * h1 + 8 * j + 2 * t4) =
                  make_float2(acc[0][j][2 * h], acc[0][j][2 * h + 1]);
          }
        }
      }
      // da2's pointwise part, da3 @ w2x^T, to the workspace: warp (rg, cg)
      // owns rows 32 rg.. and columns 16 cg.. (h0 <= 128).
      {
        const int n0 = 16 * cg;
        float acc[2][2][4];
        zero_acc(acc);
        for (int kb = 0; kb < kh1; ++kb) {
          const bf16* slab = next_slab();
          if (n0 < h0)
            mma_smem<kSteps>(acc, ch, ldc, 32 * rg, kb * kSlabK, slab, kLdSlab, 0, n0,
                             min(kSteps, (h1 - kb * kSlabK) / 16), 1);
        }
        if (n0 < h0) {
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int r = r0 + 32 * rg + 16 * m + g + 8 * h;
                if (r < K)
                  __stcs(reinterpret_cast<float2*>(da2 + (size_t)r * h0 + n0 + 8 * j + 2 * t4),
                         make_float2(acc[m][j][2 * h], acc[m][j][2 * h + 1]));
              }
        }
      }
    }
    __syncthreads();  // every warp is done with the chunk buffer
    // The pooled branch: sum_K da3 over the warps in warp order (also db2a);
    // d3c = round(it); dw2a[:h0] += pool^T d3c; dpool = d3c @ w2p^T goes to
    // the first maximal row of each column.
#pragma unroll
    for (int j = 0; j < kHalf / 2; ++j) {
      const int i = lane + 32 * j;
      if (i < hpair)
        *reinterpret_cast<float2*>(red + pair * h1 + 2 * (hoff + i)) =
            make_float2(pd[2 * j], pd[2 * j + 1]);
    }
    __syncthreads();
    for (int j = tid; j < h1; j += kMmaThreads) {
      float sum = 0.0f;
      for (int w = 0; w < kMmaWarps / 2; ++w) sum += red[w * h1 + j];
      vb2a += sum;
      d3c[j] = round_to<bf16>(sum);
    }
    __syncthreads();
    {  // 4 entries of one row a thread, 4 such loads in flight (h1 % 4 == 0)
      float4* const w4 = reinterpret_cast<float4*>(work + O.w2a);
      const int n4 = h0 * h1 / 4;
      for (int e0 = tid; e0 < n4; e0 += 4 * kMmaThreads) {
        float4 o[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (e0 + u * kMmaThreads < n4) o[u] = w4[e0 + u * kMmaThreads];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * kMmaThreads;
          if (e >= n4) continue;
          const float pv = pool[4 * e / h1];
          const float* const dc = d3c + 4 * e % h1;
          o[u].x += pv * dc[0];
          o[u].y += pv * dc[1];
          o[u].z += pv * dc[2];
          o[u].w += pv * dc[3];
          w4[e] = o[u];
        }
      }
    }
    for (int i = warp; i < h0; i += kMmaWarps) {
      const __nv_bfloat162* const wr = reinterpret_cast<const __nv_bfloat162*>(p.w2a + (size_t)i * h1);
      float acc = 0.0f;
      for (int q = lane; q < npair; q += 32) {
        const float2 w = __bfloat1622float2(wr[q]);
        acc = fmaf(d3c[2 * q], w.x, acc);
        acc = fmaf(d3c[2 * q + 1], w.y, acc);
      }
      acc = warp_sum(acc);
      if (lane == 0) da2[(size_t)arg2[i] * h0 + i] += acc;
    }
    __syncthreads();
  }
  // The block's ds2, dt2 (over the warps in warp order), db2a and db2b into
  // its slice.
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int j = 0; j < kHalf / 2; ++j) {
      const int i = lane + 32 * j;
      if (i < hpair)
        *reinterpret_cast<float2*>(red + pair * h1 + 2 * (hoff + i)) =
            pass ? make_float2(pt[2 * j], pt[2 * j + 1]) : make_float2(ps[2 * j], ps[2 * j + 1]);
    }
    __syncthreads();
    for (int j = tid; j < h1; j += kMmaThreads) {
      float sum = 0.0f;
      for (int w = 0; w < kMmaWarps / 2; ++w) sum += red[w * h1 + j];
      work[(pass ? O.t2 : O.s2) + j] += sum;
    }
    __syncthreads();
  }
  if (tid < h1) work[O.b2a + tid] += vb2a;
  if (tid < cout) work[O.b2b + tid] += vb2b;
}

// ------------------------------------------------- bf16 pass D on mma.sync
constexpr int kDTiles = 5;  // dw1a's 16 x 16 tiles a warp, at most (cin <= 160 at h0 = 128)

// dw1a's 16 x 16 tiles: C_in padded to 16, by h0.
__host__ __device__ inline int d_tiles(int cin, int h0) {
  return round_up(cin, 16) / 16 * (h0 / 16);
}

// Shared-memory layout of the pass-D kernel in bytes, every buffer 128-byte
// aligned: the fp32 da2 chunk (cp.async, one chunk ahead), the chunk's bf16
// da2c, g1 and a1 (then da1 in its place) and x, the resident weights, the
// per-column vectors, the row tiles' column sums and the exchange words of
// their row sums.
struct DLayout {
  int cinp, stage, d2c, g1, a1, xs, w1a, w1bT, vec, vs, xch, total;
  __host__ __device__ DLayout(int cin, int h0) {
    cinp = round_up(cin, 16);
    int off = 0;
    auto take = [&](int bytes) {
      const int at = off;
      off += (bytes + 127) & ~127;
      return at;
    };
    stage = take(kChunk * h0 * 4);
    d2c = take(kChunk * (h0 + 8) * 2);
    g1 = take(kChunk * (h0 + 8) * 2);
    a1 = take(kChunk * (h0 + 8) * 2);
    xs = take(kChunk * (cinp + 8) * 2);
    w1a = take(cinp * (h0 + 8) * 2);
    w1bT = take(h0 * (h0 + 8) * 2);
    vec = take(3 * h0 * 4);
    vs = take(4 * 3 * h0 * 4);
    xch = take(4 * 3 * 4 * 16 * 2 * 4);
    total = off;
  }
};

// The sum over the four warps of a row tile (warps 4 rt .. 4 rt + 3, named
// barrier 1 + rt) of values held per fragment row: v[h][k] is this warp's
// quad-summed value k of row g + 8 h. Lane t4 = 0 writes them to the warp's
// words of exchange slot x ([4 warps][16 rows][KV]); after the barrier every
// warp adds the four in warp order, so all four get the same bits. Each
// slot is used once a chunk, and block barriers separate the chunks.
template <int KV>
__device__ __forceinline__ void row_tile_sum(float (&v)[2][KV], float* x, int cq, int rt) {
  const int lane = threadIdx.x & 31, g = lane >> 2;
  if ((lane & 3) == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < KV; ++k) x[(cq * 16 + g + 8 * h) * KV + k] = v[h][k];
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + rt) : "memory");
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < KV; ++k) {
      const int at = (g + 8 * h) * KV + k;
      v[h][k] = x[at] + x[16 * KV + at] + x[32 * KV + at] + x[48 * KV + at];
    }
}

// Pass D (the stage-1 backward) in bf16 on mma.sync.m16n8k16, after
// patch_encoder_bwd_c_mma_kernel has written da2: one persistent block of 16
// warps per SM walking the same patches in the same order, writing the same
// slice. w1a (C_in padded to 16 rows) and w1b^T stay in shared memory for
// the block's life. Per 64-row chunk:
//  - da2 comes by 16-byte cp.async into an fp32 buffer, issued one chunk
//    ahead (across patches); x by 4 scalar loads a thread in flight (rows of
//    C_in = 131 are not 16-byte aligned). da2c = round(da2) goes to shared
//    memory in bf16 and db1b += sum da2 in fp32 (a column a thread);
//  - the row work: warp (rt, cq) owns rows 16 rt.. and columns 32 cq.. of
//    the chunk. Stage 1's first Dense on mma_smem over the padded C_in,
//    a1 = round(round(x w1a) + round(b1a)) on the fragments, LN statistics
//    in fp32, two-pass, the row sums added over a quad then over the row
//    tile's four warps (row_tile_sum), g1 = round(GELU(LN(a1) s1 + t1))
//    with the affine in fp32 (the reference's _bwd_kernel recompute); a1
//    (exact in bf16) and g1 to shared memory. dg1 = da2c w1b^T on the same
//    fragments, GELU' from the fp32 LN output, the LN backward (its two row
//    means through row_tile_sum), da1 rounded to bf16 in a1's place; the
//    column sums ds1, dt1, db1a over the warp's rows by shuffles, added
//    into the row tile's shared sums;
//  - the products over the chunk's rows: dw1b += g1^T da2c, warp (rb, cb)
//    owning rows 32 rb.. and columns 32 cb.. in its accumulators for the
//    block's life (A-fragments of g1^T by ldmatrix.trans); dw1a += x^T da1,
//    XT 16 x 16 tiles a warp, also in registers; dx = da1 w1a^T (B-fragments
//    of w1a^T from w1a by ldmatrix), stored per chunk when asked for.
// Three block barriers a chunk. At the block's end dw1b, dw1a and the four
// vector sums (the row tiles' in order, db1b's threads in order) are
// written to the slice once: no read-modify-write of device memory per
// chunk or per patch, no atomics, the same bits from run to run.
// Shared memory (DLayout) at C_in = 4 or 6, h0 = 128: 141,056 bytes (the da2
// chunk 32 KB; da2c, g1, a1 51 KB; w1b^T 34 KB; x, w1a, vectors, sums and
// exchange words 21 KB); at C_in = 131: 192,256 bytes. The gate admits
// d_tiles(C_in, h0) <= 16 XT, XT = kDTiles: C_in <= 160 at h0 = 128.
// Measured on the card (PERF.md): 128 registers, 8 B of stack at XT = 1 (the
// train shapes), 128 B at XT = 5; 1.73-1.87 ms at [4, 1024 x 256, 4]
// h(128, 512) -> 256 and 0.78-1.05 ms at [2, 1024 x 256, 6] -> 512, where the
// 16-row WMMA pass D it replaces took 10.8-11.0 and 5.7-5.8 ms (its slice's
// dw1b read-modify-write every 16 rows moved about 8.6 GB a launch by the
// shapes); the
// bound, the da2 read, is 0.16 / 0.08 ms.
template <int XT>
__global__ void __launch_bounds__(kMmaThreads, 1)
    patch_encoder_bwd_d_mma_kernel(Params<bf16> p) {
  using namespace psam;
  extern __shared__ __align__(128) float smem[];
  unsigned char* const base = reinterpret_cast<unsigned char*>(smem);
  const DLayout L(p.cin, p.h0);
  const GradOffsets O(p.cin, p.h0, p.h1, p.cout);
  const int K = p.K, cin = p.cin, cinp = L.cinp, h0 = p.h0;
  const bool tanh_act = p.tanh_act != 0;
  float* const stage = reinterpret_cast<float*>(base + L.stage);
  bf16* const d2c = reinterpret_cast<bf16*>(base + L.d2c);
  bf16* const g1s = reinterpret_cast<bf16*>(base + L.g1);
  bf16* const a1s = reinterpret_cast<bf16*>(base + L.a1);
  bf16* const xs = reinterpret_cast<bf16*>(base + L.xs);
  bf16* const w1a = reinterpret_cast<bf16*>(base + L.w1a);
  bf16* const w1bT = reinterpret_cast<bf16*>(base + L.w1bT);
  float* const b1a = reinterpret_cast<float*>(base + L.vec);  // rounded to bf16
  float* const s1 = b1a + h0;
  float* const t1 = s1 + h0;
  float* const vs = reinterpret_cast<float*>(base + L.vs);  // [row tile][ds1, dt1, db1a][h0]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int lda = h0 + 8, ldx = cinp + 8, npairs = h0 / 16;
  const bf16 zero = __float2bfloat16_rn(0.0f);
  float* const work = p.work + (size_t)blockIdx.x * O.total;

  // The block's chunks in order: patches s, s + nblocks, ..., each in 64-row
  // chunks. Chunk q's da2 goes to the stage buffer, rows past K zero-filled.
  const int nch = round_up(K, kChunk) / kChunk;
  const int n_chunks = ((p.npatch - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) * nch;
  const int seg = h0 / 4;  // 16-byte segments a row
  auto issue = [&](int q) {
    if (q < n_chunks) {
      const int pi = blockIdx.x + (q / nch) * gridDim.x, r0 = (q % nch) * kChunk;
      const int nr = imin(kChunk, K - r0);
      const float* const src = p.da2 + ((size_t)pi * K + r0) * h0;
      for (int e = tid; e < kChunk * seg; e += kMmaThreads) {
        const int r = e / seg, c = (e % seg) * 4;
        cp_async16(smem_u32(stage + r * h0 + c), r < nr ? src + (size_t)r * h0 + c : src, r < nr);
      }
    }
    cp_async_commit();
  };

  copy_tile_async(w1a, lda, p.w1a, h0, 0, cinp, cin, 0, h0, h0);
  copy_tile_async(w1bT, lda, p.w1bT, h0, 0, h0, h0, 0, h0, h0);
  cp_async_commit();
  issue(0);
  for (int i = tid; i < h0; i += kMmaThreads) {
    b1a[i] = round_to<bf16>(p.b1a[i]);
    s1[i] = p.s1[i];
    t1[i] = p.t1[i];
  }
  for (int i = tid; i < kChunk * ldx; i += kMmaThreads) xs[i] = zero;  // columns cin.. stay zero
  for (int i = tid; i < 4 * 3 * h0; i += kMmaThreads) vs[i] = 0.0f;

  // Warp roles: the row work (rows 16 rt.., columns 32 cq.., np column
  // pairs) and dw1b's tile (rows 32 rb.., columns 32 cb..; mtb row tiles and
  // npb column pairs of it in range).
  const int rt = warp >> 2, cq = warp & 3, rb = warp >> 2, cb = warp & 3;
  const int wc = 32 * cq, np = imin(2, max(0, npairs - 2 * cq));
  const int mtb = imin(2, max(0, npairs - 2 * rb)), npb = imin(2, max(0, npairs - 2 * cb));
  float* const xr = reinterpret_cast<float*>(base + L.xch) + rt * 3 * 128;  // 3 slots
  const int ta = d_tiles(cin, h0);
  float accB[2][4][4], accA[XT][1][2][4];
  zero_acc(accB);
#pragma unroll
  for (int i = 0; i < XT; ++i) zero_acc(accA[i]);
  // db1b: this thread's column dcol over rows dq, dq + nq, ... of each chunk.
  const int nq = kMmaThreads / h0, dcol = tid % h0, dq = tid / h0;
  float vb1b = 0.0f;
  cp_async_wait<0>();
  __syncthreads();

  for (int q = 0; q < n_chunks; ++q) {
    const int pi = blockIdx.x + (q / nch) * gridDim.x, r0 = (q % nch) * kChunk;
    const int nr = imin(kChunk, K - r0);
    // x -> xs (rows past K zero), then da2c = round(da2) and db1b.
    const bf16* __restrict__ xc = p.x + ((size_t)pi * K + r0) * cin;
    for (int e0 = tid; e0 < kChunk * cin; e0 += 4 * kMmaThreads) {
      bf16 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * kMmaThreads;
        v[u] = e < nr * cin ? xc[e] : zero;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = e0 + u * kMmaThreads, r = e / cin;
        if (e < kChunk * cin) xs[r * ldx + e - r * cin] = v[u];
      }
    }
    if (dq < nq)
      for (int r = dq; r < kChunk; r += nq) {
        const float v = stage[r * h0 + dcol];
        vb1b += v;
        d2c[r * lda + dcol] = __float2bfloat16_rn(v);
      }
    __syncthreads();  // xs and da2c complete; the stage buffer is free
    issue(q + 1);

    // Stage 1: a1 = round(round(x w1a) + round(b1a)), its LN statistics.
    float acc[1][4][4];
    zero_acc(acc);
    if (np > 0) mma_smem<1>(acc, xs, ldx, 16 * rt, 0, w1a, lda, 0, wc, cinp / 16, np);
    float st[2][1] = {{0.0f}, {0.0f}}, mean[2], inv[2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= 2 * np) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float& v = acc[0][j][i];
        v = round_to<bf16>(round_to<bf16>(v) + b1a[wc + 8 * j + 2 * t4 + (i & 1)]);
        st[i >> 1][0] += v;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) st[h][0] = quad_sum(st[h][0]);
    row_tile_sum<1>(st, xr, cq, rt);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mean[h] = st[h][0] / h0;
      st[h][0] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= 2 * np) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = acc[0][j][i] - mean[i >> 1];
        st[i >> 1][0] += d * d;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) st[h][0] = quad_sum(st[h][0]);
    row_tile_sum<1>(st, xr + 128, cq, rt);
#pragma unroll
    for (int h = 0; h < 2; ++h) inv[h] = rsqrtf(st[h][0] / h0 + 1e-5f);
    // a1 (exact in bf16) and g1 = round(GELU(LN(a1) s1 + t1)) to shared memory.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j >= 2 * np) continue;
      const int col = wc + 8 * j + 2 * t4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int at = (16 * rt + g + 8 * h) * lda + col;
        const float v0 = acc[0][j][2 * h], v1 = acc[0][j][2 * h + 1];
        *reinterpret_cast<__nv_bfloat162*>(a1s + at) = __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(g1s + at) = __floats2bfloat162_rn(
            act_fwd((v0 - mean[h]) * inv[h] * s1[col] + t1[col], tanh_act),
            act_fwd((v1 - mean[h]) * inv[h] * s1[col + 1] + t1[col + 1], tanh_act));
      }
    }

    // dg1 = da2c w1b^T; dl = dg1 GELU'(y); ds1 += dl xhat, dt1 += dl; the LN
    // backward da1 = inv (dl s - mean(dl s) - xhat mean(dl s xhat)).
    zero_acc(acc);
    if (np > 0) mma_smem<4>(acc, d2c, lda, 16 * rt, 0, w1bT, lda, 0, wc, npairs, np);
    float m[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}}, cs[2][4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      cs[0][j][0] = cs[0][j][1] = cs[1][j][0] = cs[1][j][1] = 0.0f;
      if (j >= 2 * np) continue;
      const int col = wc + 8 * j + 2 * t4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(a1s + (16 * rt + g + 8 * h) * lda + col));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float xh = ((e ? a.y : a.x) - mean[h]) * inv[h];
          const float dl =
              acc[0][j][2 * h + e] * act_grad(xh * s1[col + e] + t1[col + e], tanh_act);
          cs[0][j][e] = fmaf(dl, xh, cs[0][j][e]);
          cs[1][j][e] += dl;
          const float d = dl * s1[col + e];
          acc[0][j][2 * h + e] = d;
          m[h][0] += d;
          m[h][1] += d * xh;
        }
      }
    }
    float* const vrow = vs + rt * 3 * h0;
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = rows_sum(cs[k][j][e]);
          if (g == 0 && j < 2 * np) vrow[k * h0 + wc + 8 * j + 2 * t4 + e] += v;
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h][0] = quad_sum(m[h][0]);
      m[h][1] = quad_sum(m[h][1]);
    }
    row_tile_sum<2>(m, xr + 256, cq, rt);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float db[2] = {0.0f, 0.0f};
      if (j < 2 * np) {
        const int col = wc + 8 * j + 2 * t4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          __nv_bfloat162* const at =
              reinterpret_cast<__nv_bfloat162*>(a1s + (16 * rt + g + 8 * h) * lda + col);
          const float2 a = __bfloat1622float2(*at);
          float da[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float xh = ((e ? a.y : a.x) - mean[h]) * inv[h];
            da[e] = inv[h] * (acc[0][j][2 * h + e] - m[h][0] / h0 - xh * (m[h][1] / h0));
            db[e] += da[e];
          }
          *at = __floats2bfloat162_rn(da[0], da[1]);  // da1, rounded, in a1's place
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = rows_sum(db[e]);
        if (g == 0 && j < 2 * np) vrow[2 * h0 + wc + 8 * j + 2 * t4 + e] += v;
      }
    }
    __syncthreads();  // g1 and da1 complete

    // dw1b += g1^T da2c, dw1a += x^T da1 over the chunk's rows (rows past K
    // carry zero gradients); dx = da1 w1a^T.
    if (mtb > 0 && npb > 0)
      mma_smem_tn<4>(accB, g1s, lda, 0, 32 * rb, d2c, lda, 0, 32 * cb, kChunk / 16, npb, mtb);
#pragma unroll
    for (int i = 0; i < XT; ++i) {
      const int t = warp + kMmaWarps * i;
      if (t < ta)
        mma_smem_tn<4>(accA[i], xs, ldx, 0, 16 * (t / npairs), a1s, lda, 0, 16 * (t % npairs),
                       kChunk / 16, 1);
    }
    if (p.dx) {
      bf16* const dxc = p.dx + ((size_t)pi * K + r0) * cin;
      for (int t = warp; t < 4 * (cinp / 16); t += kMmaWarps) {
        const int mr = t & 3, c0 = 16 * (t >> 2);
        float ad[1][2][4];
        zero_acc(ad);
        mma_smem_nt<4>(ad, a1s, lda, 16 * mr, 0, w1a, lda, 0, c0, npairs, 1);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = 16 * mr + g + 8 * (i >> 1), c = c0 + 8 * jj + 2 * t4 + (i & 1);
            if (r < nr && c < cin) dxc[r * cin + c] = __float2bfloat16_rn(ad[0][jj][i]);
          }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the next chunk's da2 has landed; this chunk's buffers are free
  }

  // The block's grads into its slice, once.
#pragma unroll
  for (int mm = 0; mm < 2; ++mm)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (mm < mtb && j < 2 * npb)
          *reinterpret_cast<float2*>(work + O.w1b +
                                     (size_t)(32 * rb + 16 * mm + g + 8 * h) * h0 + 32 * cb +
                                     8 * j + 2 * t4) =
              make_float2(accB[mm][j][2 * h], accB[mm][j][2 * h + 1]);
#pragma unroll
  for (int i = 0; i < XT; ++i) {
    const int t = warp + kMmaWarps * i;
    if (t >= ta) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * (t / npairs) + g + 8 * h;
        if (r < cin)
          *reinterpret_cast<float2*>(work + O.w1a + (size_t)r * h0 + 16 * (t % npairs) + 8 * j +
                                     2 * t4) = make_float2(accA[i][0][j][2 * h],
                                                           accA[i][0][j][2 * h + 1]);
      }
  }
  if (dq < nq) stage[dq * h0 + dcol] = vb1b;  // free: the last chunk ended in a wait
  __syncthreads();
  for (int i = tid; i < h0; i += kMmaThreads) {
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int r = 0; r < 4; ++r)
      for (int k = 0; k < 3; ++k) v[k] += vs[(r * 3 + k) * h0 + i];
    for (int r = 0; r < nq; ++r) v[3] += stage[r * h0 + i];
    work[O.s1 + i] = v[0];
    work[O.t1 + i] = v[1];
    work[O.b1a + i] = v[2];
    work[O.b1b + i] = v[3];
  }
}

// grads[e] = sum over the slices, in slice order, of work[s][e'] (e' = e
// except in dw2b, which the slices hold transposed).
__global__ void reduce_slices_kernel(const float* __restrict__ work, int nslices, GradOffsets O,
                                     int h1, int cout, float* __restrict__ grads) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= O.total) return;
  int src = e;
  if (e >= O.w2b && e < O.b2b) {
    const int j = (e - O.w2b) / cout, c = (e - O.w2b) % cout;
    src = O.w2b + c * h1 + j;
  }
  float acc = 0.0f;
  for (int s = 0; s < nslices; ++s) acc += work[(size_t)s * O.total + src];
  grads[e] = acc;
}

int num_sms() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 1;
  return n > 0 ? n : 1;
}

// The most dynamic shared memory a block of the current device may use.
int smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

// The bf16 route's gate: K2's mma gate (h0 <= 128, h0, h1 and C_out
// multiples of 16), the pass-C kernel's shared memory within the device's
// limit (K <= 256 at h(128, 512)), and the pass-D kernel's: its dw1a tiles
// in registers (C_in <= 160 at h0 = 128) and its shared memory.
bool mma_route(int K, int cin, int h0, int h1, int cout, int dtype) {
  static const int limit = smem_optin();
  return dtype == 1 && h0 % 16 == 0 && h0 <= 8 * kNt1 && h1 % 16 == 0 && cout % 16 == 0 &&
         CLayout(K, cin, h0, h1, cout).total <= limit &&
         d_tiles(cin, h0) <= kDTiles * kMmaWarps && DLayout(cin, h0).total <= limit;
}

// Passes: bit 0 pass C, bit 1 pass D, bit 2 the slices' reduction. The bf16
// mma route launches C (patch_encoder_bwd_c_mma_kernel) and D
// (patch_encoder_bwd_d_mma_kernel) apart, so that a caller may time them; every
// other shape runs both passes in patch_encoder_bwd_kernel and takes all
// three bits. Each kernel's shared-memory limit is raised to the device's
// maximum once per instantiation, at its first launch (the port runs on one
// device); a launch that needs more fails and its error is returned.
template <typename T>
int run(const Params<T>& p, int nslices, float* grads, bool mma, int passes,
        cudaStream_t stream) {
  static const int limit = smem_optin();
  const Layout L(p.cin, p.h0, p.h1, p.cout, p.K);
  const size_t smem = (size_t)L.total * sizeof(float);
  cudaError_t err = cudaSuccess;
  if (!mma) {
    if (passes != 7) return (int)cudaErrorInvalidValue;
    static const cudaError_t attr = cudaFuncSetAttribute(
        patch_encoder_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (attr != cudaSuccess) return (int)attr;
    patch_encoder_bwd_kernel<T><<<nslices, kThreads, smem, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  } else if constexpr (std::is_same<T, bf16>::value) {
    if (passes & 1) {
      static const cudaError_t attr = cudaFuncSetAttribute(
          patch_encoder_bwd_c_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
      if (attr != cudaSuccess) return (int)attr;
      if (!aligned16(p.w1a) || !aligned16(p.w1b) || !aligned16(p.w2a) || !aligned16(p.w2xT))
        return (int)cudaErrorMisalignedAddress;
      const CLayout C(p.K, p.cin, p.h0, p.h1, p.cout);
      patch_encoder_bwd_c_mma_kernel<<<nslices, kMmaThreads, C.total, stream>>>(p);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    if (passes & 2) {
      static const cudaError_t attr1 = cudaFuncSetAttribute(
          patch_encoder_bwd_d_mma_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
      static const cudaError_t attr5 = cudaFuncSetAttribute(
          patch_encoder_bwd_d_mma_kernel<kDTiles>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          limit);
      if (attr1 != cudaSuccess) return (int)attr1;
      if (attr5 != cudaSuccess) return (int)attr5;
      if (!aligned16(p.w1a) || !aligned16(p.w1bT) || !aligned16(p.da2))
        return (int)cudaErrorMisalignedAddress;
      const DLayout D(p.cin, p.h0);
      if (d_tiles(p.cin, p.h0) <= kMmaWarps)
        patch_encoder_bwd_d_mma_kernel<1><<<nslices, kMmaThreads, D.total, stream>>>(p);
      else
        patch_encoder_bwd_d_mma_kernel<kDTiles><<<nslices, kMmaThreads, D.total, stream>>>(p);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (passes & 4) {
    const GradOffsets O(p.cin, p.h0, p.h1, p.cout);
    reduce_slices_kernel<<<(O.total + 255) / 256, 256, 0, stream>>>(p.work, nslices, O, p.h1,
                                                                     p.cout, grads);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The number of workspace slices (persistent blocks) for ``npatch`` patches:
// one per SM, at most one per patch.
extern "C" int psam_patch_encoder_bwd_slices(int npatch) {
  return std::max(1, std::min(npatch, num_sms()));
}

// 1 when psam_patch_encoder_bwd takes the bf16 mma route at these sizes
// (pass C on patch_encoder_bwd_c_mma_kernel, pass D on
// patch_encoder_bwd_d_mma_kernel), else 0 (both passes in
// patch_encoder_bwd_kernel).
extern "C" int psam_patch_encoder_bwd_route(int K, int cin, int h0, int h1, int cout, int dtype) {
  return mma_route(K, cin, h0, h1, cout, dtype) ? 1 : 0;
}

// x [B, G*K, cin], dout [B, G, cout] and the weight matrices ([in, out]) and
// their transposes ([out, in]) in the compute dtype (0 = float32,
// 1 = bfloat16); biases and LN parameters fp32. pool [B, G, h0] (compute
// dtype), arg2 [B, G, h0] and arg4 [B, G, cout] (int32, rows in [0, K)):
// K2's saved max-pools and first argmaxes for the same x and weights.
// dx: [B, G*K, cin] in the compute dtype, or null. da2: fp32 workspace
// [B*G*K, h0]. work: fp32 [nslices, 12 grads], zeroed. grads: fp32, the 12
// parameter grads flattened in order. h0, h1, cout <= 512. passes: 7 (C, D
// and the reduction); on the mma route any subset, for timing them apart
// (D reads the da2 that C wrote). On the mma route w1a, w1b, w2a, w1bT,
// w2xT and da2 are copied by 16-byte cp.async: their pointers must be
// 16-byte aligned,
// as fresh torch allocations are, else the call returns
// cudaErrorMisalignedAddress.
extern "C" int psam_patch_encoder_bwd(const void* x, const void* dout, const void* pool,
                                      const void* arg2, const void* arg4, int B, int G, int K,
                                      int cin, const void* w1a, const void* b1a, const void* s1,
                                      const void* t1, const void* w1b, const void* b1b,
                                      const void* w2a, const void* b2a, const void* s2,
                                      const void* t2, const void* w1aT, const void* w1bT,
                                      const void* w2pT, const void* w2xT, const void* w2bT,
                                      int h0, int h1, int cout, void* dx, void* da2, void* work,
                                      int nslices, void* grads, int tanh_act, int dtype,
                                      int passes, void* stream) {
  const int lim = 32 * psam::kMaxPerLane;
  if (B <= 0 || G <= 0 || K <= 0 || cin <= 0 || h0 <= 0 || h1 <= 0 || cout <= 0 ||
      h0 > lim || h1 > lim || cout > lim || nslices <= 0 || !pool || !arg2 || !arg4 ||
      passes <= 0 || passes > 7)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool mma = mma_route(K, cin, h0, h1, cout, dtype);
  auto fill = [&](auto* typed) {
    using T = std::remove_cv_t<std::remove_pointer_t<decltype(typed)>>;
    Params<T> p;
    p.x = static_cast<const T*>(x);
    p.dout = static_cast<const T*>(dout);
    p.pool = static_cast<const T*>(pool);
    p.arg2 = static_cast<const int*>(arg2);
    p.arg4 = static_cast<const int*>(arg4);
    p.w1a = static_cast<const T*>(w1a);
    p.b1a = static_cast<const float*>(b1a);
    p.s1 = static_cast<const float*>(s1);
    p.t1 = static_cast<const float*>(t1);
    p.w1b = static_cast<const T*>(w1b);
    p.b1b = static_cast<const float*>(b1b);
    p.w2a = static_cast<const T*>(w2a);
    p.b2a = static_cast<const float*>(b2a);
    p.s2 = static_cast<const float*>(s2);
    p.t2 = static_cast<const float*>(t2);
    p.w1aT = static_cast<const T*>(w1aT);
    p.w1bT = static_cast<const T*>(w1bT);
    p.w2pT = static_cast<const T*>(w2pT);
    p.w2xT = static_cast<const T*>(w2xT);
    p.w2bT = static_cast<const T*>(w2bT);
    p.dx = static_cast<T*>(dx);
    p.da2 = static_cast<float*>(da2);
    p.work = static_cast<float*>(work);
    p.npatch = B * G;
    p.K = K;
    p.cin = cin;
    p.h0 = h0;
    p.h1 = h1;
    p.cout = cout;
    p.tanh_act = tanh_act;
    p.tc = std::is_same<T, bf16>::value && h0 % 16 == 0 && h1 % 16 == 0 && cout % 16 == 0;
    return run<T>(p, nslices, static_cast<float*>(grads), mma, passes, st);
  };
  if (dtype == 1) return fill(static_cast<bf16*>(nullptr));
  return fill(static_cast<float*>(nullptr));
}
