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
// memory, so they are recomputed per 16-row tile. The one exception is the
// stage-1 output gradient da2 (fp32 [rows, h0], 0.27-0.54 GB at the train
// shapes): it needs the whole patch's sum of da3 before it is complete, so
// it goes to a workspace and is read back once.
// Design: on the TPU the parameter grads add up over a sequential grid;
// here blocks run in no order. So the kernel runs one persistent block per
// SM; block s walks the patches s, s + nblocks, ... in order and adds its
// parameter grads into its own fp32 workspace slice (no other block writes
// it), and a second launch adds the slices in slice order. No atomics: the
// grads are the same from run to run.
// Products: in bf16 with widths that are multiples of 16, every product
// with a wide operand runs on the tensor cores (WMMA 16x16x16, fp32
// accumulation): its operands are rounded to bf16 anyway, so bf16 copies
// of them in shared memory make the products exact up to summation order.
// The 16-row tile is one WMMA row tile; a warp owns 16-column output tiles
// and reads its weight fragments from L2. The weight-gradient products
// (a^T b over the tile's rows) add their 16x16 tiles straight into the
// block's workspace slice. The narrow products (C_in columns), the sparse
// max-pool ones and the fp32 path run as FMA loops.
// Per patch, two passes over its rows:
//   C: stage 1 + stage-2 up to GELU -> the stage-2 backward, da2's
//      pointwise part to the workspace; then the pooled branch;
//   D: stage 1 without its second Dense -> the stage-1 backward, dx.
#include <mma.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

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

template <typename T>
__global__ void __launch_bounds__(kThreads) patch_encoder_bwd_kernel(Params<T> p) {
  using namespace psam;
  extern __shared__ __align__(128) float sm[];
  const Layout L(p.cin, p.h0, p.h1, p.cout, p.K);
  const GradOffsets O(p.cin, p.h0, p.h1, p.cout);
  const int h0 = p.h0, h1 = p.h1, cout = p.cout, K = p.K, ldt = L.ldt;
  const bool tanh_act = p.tanh_act != 0, tc = p.tc != 0;
  float* work = p.work + (size_t)blockIdx.x * O.total;
  bf16* a2b = reinterpret_cast<bf16*>(sm + L.a2b);
  bf16* g1b = reinterpret_cast<bf16*>(sm + L.g1b);
  bf16* d2b = reinterpret_cast<bf16*>(sm + L.d2b);
  bf16* d3b = reinterpret_cast<bf16*>(sm + L.d3b);
  float* pool = sm + L.pool;
  int* arg2 = reinterpret_cast<int*>(sm + L.arg2);
  int* arg4 = reinterpret_cast<int*>(sm + L.arg4);
  float* dov = sm + L.dov;
  int* cstart = reinterpret_cast<int*>(sm + L.cstart);
  int* corder = reinterpret_cast<int*>(sm + L.corder);
  float* d3 = sm + L.d3;
  float* t3 = sm + L.t3;

  for (int e = threadIdx.x; e < 4 * pad8(h0) + 3 * pad8(h1) + pad8(cout); e += blockDim.x)
    sm[L.vb1a + e] = 0.0f;  // the block's vector-grad sums (vb1a .. vb2b)

  for (int pi = blockIdx.x; pi < p.npatch; pi += gridDim.x) {
    const T* xpatch = p.x + (size_t)pi * K * p.cin;
    float* da2 = p.da2 + (size_t)pi * K * h0;
    // The max-pools and their first argmaxes, as K2's forward found them.
    for (int i = threadIdx.x; i < h0; i += blockDim.x) {
      pool[i] = to_f32<T>(p.pool[(size_t)pi * h0 + i]);
      arg2[i] = p.arg2[(size_t)pi * h0 + i];
    }
    for (int c = threadIdx.x; c < cout; c += blockDim.x) {
      arg4[c] = p.arg4[(size_t)pi * cout + c];
      dov[c] = to_f32<T>(p.dout[(size_t)pi * cout + c]);
    }
    for (int j = threadIdx.x; j < h1; j += blockDim.x) d3[j] = 0.0f;
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

    // Pass C: the stage-2 backward.
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
    for (int c = threadIdx.x; c < cout; c += blockDim.x) sm[L.vb2b + c] += dov[c];
    __syncthreads();
    for (int e = threadIdx.x; e < h0 * h1; e += blockDim.x)
      work[O.w2a + e] += pool[e / h1] * d3[e % h1];
    rows_matmul<T, 1>(d3, h1, h1, p.w2pT, h0, sm + L.dpool, h0);
    __syncthreads();
    for (int i = threadIdx.x; i < h0; i += blockDim.x)
      da2[(size_t)arg2[i] * h0 + i] += sm[L.dpool + i];
    __syncthreads();

    // Pass D: the stage-1 backward.
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
  // The block's vector sums into its slice.
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

// The kernel's shared-memory limit is raised to the device's maximum once
// per instantiation, at its first launch (the port runs on one device); a
// launch that needs more fails and its error is returned.
template <typename T>
int run(const Params<T>& p, int nslices, float* grads, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      patch_encoder_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin());
  if (attr != cudaSuccess) return (int)attr;
  const Layout L(p.cin, p.h0, p.h1, p.cout, p.K);
  const size_t smem = (size_t)L.total * sizeof(float);
  patch_encoder_bwd_kernel<T><<<nslices, kThreads, smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const GradOffsets O(p.cin, p.h0, p.h1, p.cout);
  reduce_slices_kernel<<<(O.total + 255) / 256, 256, 0, stream>>>(p.work, nslices, O, p.h1,
                                                                   p.cout, grads);
  return (int)cudaGetLastError();
}

}  // namespace

// The number of workspace slices (persistent blocks) for ``npatch`` patches:
// one per SM, at most one per patch.
extern "C" int psam_patch_encoder_bwd_slices(int npatch) {
  return std::max(1, std::min(npatch, num_sms()));
}

// x [B, G*K, cin], dout [B, G, cout] and the weight matrices ([in, out]) and
// their transposes ([out, in]) in the compute dtype (0 = float32,
// 1 = bfloat16); biases and LN parameters fp32. pool [B, G, h0] (compute
// dtype), arg2 [B, G, h0] and arg4 [B, G, cout] (int32, rows in [0, K)):
// K2's saved max-pools and first argmaxes for the same x and weights.
// dx: [B, G*K, cin] in the compute dtype, or null. da2: fp32 workspace
// [B*G*K, h0]. work: fp32 [nslices, 12 grads], zeroed. grads: fp32, the 12
// parameter grads flattened in order. h0, h1, cout <= 512.
extern "C" int psam_patch_encoder_bwd(const void* x, const void* dout, const void* pool,
                                      const void* arg2, const void* arg4, int B, int G, int K,
                                      int cin, const void* w1a, const void* b1a, const void* s1,
                                      const void* t1, const void* w1b, const void* b1b,
                                      const void* w2a, const void* b2a, const void* s2,
                                      const void* t2, const void* w1aT, const void* w1bT,
                                      const void* w2pT, const void* w2xT, const void* w2bT,
                                      int h0, int h1, int cout, void* dx, void* da2, void* work,
                                      int nslices, void* grads, int tanh_act, int dtype,
                                      void* stream) {
  const int lim = 32 * psam::kMaxPerLane;
  if (B <= 0 || G <= 0 || K <= 0 || cin <= 0 || h0 <= 0 || h1 <= 0 || cout <= 0 ||
      h0 > lim || h1 > lim || cout > lim || nslices <= 0 || !pool || !arg2 || !arg4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
    return run<T>(p, nslices, static_cast<float*>(grads), st);
  };
  if (dtype == 1) return fill(static_cast<bf16*>(nullptr));
  return fill(static_cast<float*>(nullptr));
}
