// K2: the PointNet patch encoder, fused.
//
// Replaces point_sam_tpu/ops/patch_encoder_pallas.py::patch_encoder_fused
// (_kernel). Per patch of K grouped points [K, C_in]:
//   h  = Dense(C_in->h0) -> LN -> GELU -> Dense(h0->h0)     (stage 1)
//   p  = max_K h;  up_pool = p @ W2a[:h0]
//   u  = h @ W2a[h0:] + up_pool + b2a -> LN -> GELU -> Dense(h1->C_out)
//   out = max_K u                                           (stage 2)
// with the flax Dense rounding (product rounded to the compute dtype, bias
// added in it), fp32 two-pass LN statistics (eps 1e-5), and LN -> GELU
// fused in fp32 (erf) or with the affine in the compute dtype (tanh).
//
// What bounds it on the H100: at the encode shape (2048 patches x 256
// points) the [G*K, 512] hidden activations are 0.5-1 GB per tensor; the
// unfused chain moves several GB through device memory. Kept on chip, the
// work is ~0.4 TFLOP of matmuls whose weights (0.5 MB in bf16) are re-read
// from L2 once per row tile, so the rows per tile set the L2 traffic.
// Design: one block per (patch, cloud) walks its K rows in row tiles held in
// shared memory, in two passes: pass 1 computes stage 1 and the max-pool,
// pass 2 recomputes stage 1 (cheaper than holding [K, h0]) and runs stage 2
// with a running max. Only [C_out] per patch is written. The grouped input
// is read pre-gathered [B, G*K, C_in], as the JAX kernel takes it.
// - bf16 (widths multiples of 16, h0 <= 128, h1 <= 512): 64-row tiles; the
//   h0/h1/C_out products run on the tensor cores (WMMA 16x16x16, fp32
//   accumulation) in 128-column slices, one column tile per warp, each
//   weight fragment feeding the 4 row tiles. Activations are stored in bf16,
//   which is exact: the reference rounds them to bf16 at every step.
// - otherwise (fp32, odd widths): 16-row tiles and plain FMA loops.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

__host__ __device__ __forceinline__ int pad8(int n) { return (n + 7) & ~7; }

template <typename T>
struct Params {
  const T* x;
  const T* w1a; const float* b1a; const float* s1; const float* t1;
  const T* w1b; const float* b1b;
  const T* w2a; const float* b2a; const float* s2; const float* t2;
  const T* w2b; const float* b2b;
  T* out;
  int G, K, cin, h0, h1, cout, tanh_act;
};

// Load rows [r0, r0 + nr) of the patch into xs [rows][pad8(cin)] (fp32),
// zero past nr.
template <typename T>
__device__ __forceinline__ void load_rows(const Params<T>& p, const T* __restrict__ xpatch,
                                          int r0, int nr, int rows, float* xs) {
  const int cl = pad8(p.cin);
  for (int e = threadIdx.x; e < rows * cl; e += blockDim.x) {
    const int r = e / cl, c = e % cl;
    xs[e] = (r < nr && c < p.cin) ? psam::to_f32<T>(xpatch[(size_t)(r0 + r) * p.cin + c])
                                  : 0.0f;
  }
}

// ---------------------------------------------------------------- FMA path
constexpr int kThreads = 128;
constexpr int kRows = 16;

// Shared-memory layout, in floats; every buffer starts 32-byte aligned.
struct Layout {
  int xs, a, hbuf, u, y, pooled, up_pool, omax, total;
  __host__ __device__ Layout(int cin, int h0, int h1, int cout) {
    int off = 0;
    auto take = [&](int floats) { const int at = off; off += pad8(floats); return at; };
    xs = take(kRows * pad8(cin));
    a = take(kRows * h0);
    hbuf = take(kRows * h0);
    u = take(kRows * h1);
    y = take(kRows * cout);
    pooled = take(h0);
    up_pool = take(h1);
    omax = take(cout);
    total = off;
  }
};

// Stage 1 on rows [r0, r0 + nr) of this patch -> hbuf [kRows][h0].
template <typename T>
__device__ void stage1(const Params<T>& p, const T* __restrict__ xpatch, int r0, int nr,
                       float* smem, const Layout& L) {
  using namespace psam;
  float* xs = smem + L.xs;
  float* a = smem + L.a;
  float* hbuf = smem + L.hbuf;
  load_rows<T>(p, xpatch, r0, nr, kRows, xs);
  __syncthreads();
  rows_matmul<T, kRows>(xs, pad8(p.cin), p.cin, p.w1a, p.h0, a, p.h0);
  __syncthreads();
  rows_epilogue<T>(a, p.h0, kRows, p.h0, nullptr, p.b1a, p.s1, p.t1, p.tanh_act != 0,
                   nullptr, 0);
  __syncthreads();
  rows_matmul<T, kRows>(a, p.h0, p.h0, p.w1b, p.h0, hbuf, p.h0);
  __syncthreads();
  rows_epilogue<T>(hbuf, p.h0, kRows, p.h0, nullptr, p.b1b, nullptr, nullptr, false,
                   nullptr, 0);
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads) patch_encoder_kernel(Params<T> p) {
  using namespace psam;
  extern __shared__ __align__(128) float smem[];
  const Layout L(p.cin, p.h0, p.h1, p.cout);
  const int h0 = p.h0, h1 = p.h1, cout = p.cout;
  float* hbuf = smem + L.hbuf;
  float* u = smem + L.u;
  float* y = smem + L.y;
  float* pooled = smem + L.pooled;
  float* up_pool = smem + L.up_pool;
  float* omax = smem + L.omax;

  const int gidx = blockIdx.x, b = blockIdx.y;
  const T* xpatch = p.x + ((size_t)b * p.G + gidx) * p.K * p.cin;

  for (int c = threadIdx.x; c < h0; c += blockDim.x) pooled[c] = -INFINITY;
  for (int c = threadIdx.x; c < cout; c += blockDim.x) omax[c] = -INFINITY;

  // Pass 1: stage 1 and the max over K.
  for (int r0 = 0; r0 < p.K; r0 += kRows) {
    const int nr = min(kRows, p.K - r0);
    stage1<T>(p, xpatch, r0, nr, smem, L);
    for (int c = threadIdx.x; c < h0; c += blockDim.x) {
      float m = pooled[c];
      for (int r = 0; r < nr; ++r) m = fmaxf(m, hbuf[r * h0 + c]);
      pooled[c] = m;
    }
    __syncthreads();
  }
  // The pooled half of the stage-2 Dense is constant over K: one row.
  rows_matmul<T, 1>(pooled, h0, h0, p.w2a, h1, up_pool, h1);
  __syncthreads();

  // Pass 2: stage 1 again, stage 2, running max over K.
  for (int r0 = 0; r0 < p.K; r0 += kRows) {
    const int nr = min(kRows, p.K - r0);
    stage1<T>(p, xpatch, r0, nr, smem, L);
    rows_matmul<T, kRows>(hbuf, h0, h0, p.w2a + (size_t)h0 * h1, h1, u, h1);
    __syncthreads();
    rows_epilogue<T>(u, h1, kRows, h1, up_pool, p.b2a, p.s2, p.t2, p.tanh_act != 0, nullptr,
                     0);
    __syncthreads();
    rows_matmul<T, kRows>(u, h1, h1, p.w2b, cout, y, cout);
    __syncthreads();
    for (int o = threadIdx.x; o < cout; o += blockDim.x) {
      const float bias = round_to<T>(p.b2b[o]);
      float m = omax[o];
      for (int r = 0; r < nr; ++r) m = fmaxf(m, round_to<T>(round_to<T>(y[r * cout + o]) + bias));
      omax[o] = m;
    }
    __syncthreads();
  }
  for (int o = threadIdx.x; o < cout; o += blockDim.x)
    p.out[((size_t)b * p.G + gidx) * cout + o] = from_f32<T>(omax[o]);
}

// ------------------------------------------------------- tensor-core path
constexpr int kTcThreads = 256;  // 8 warps: one 16-column tile each
constexpr int kTcRows = 64;      // 4 WMMA row tiles
constexpr int kTcCols = 128;     // column slice of one product

// Shared-memory layout in floats (bf16 buffers take half a float per value).
struct TcLayout {
  int xs, c, abf, hbf, ubf, pooled, up_pool, omax, total;
  __host__ __device__ TcLayout(int cin, int h0, int h1, int cout) {
    int off = 0;
    auto take = [&](int floats) { const int at = off; off += pad8(floats); return at; };
    xs = take(kTcRows * pad8(cin));
    c = take(kTcRows * kTcCols);         // fp32 product slice
    abf = take(kTcRows * (h0 + 8) / 2);  // row stride +8 against bank conflicts
    hbf = take(kTcRows * (h0 + 8) / 2);
    ubf = take(kTcRows * (h1 + 8) / 2);
    pooled = take(h0);
    up_pool = take(h1);
    omax = take(cout);
    total = off;
  }
};

// C[64 x 128] (fp32, row stride kTcCols) = A[64 x K] (bf16, shared, lda) @
// W[K x ldw] columns [n0, n0 + ncols) (bf16, row-major, global). Warp w owns
// column tile w; each weight fragment it loads feeds the 4 row tiles.
__device__ void tile_matmul(const bf16* __restrict__ A, int lda, int K,
                            const bf16* __restrict__ W, int ldw, int n0, int ncols,
                            float* __restrict__ C) {
  using namespace nvcuda;
  const int w = threadIdx.x >> 5;
  if (16 * w >= ncols) return;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) wmma::fill_fragment(acc[m], 0.0f);
  for (int k = 0; k < K; k += 16) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
    wmma::load_matrix_sync(bw, W + (size_t)k * ldw + n0 + 16 * w, ldw);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, A + 16 * m * lda + k, lda);
      wmma::mma_sync(acc[m], a, bw, acc[m]);
    }
  }
#pragma unroll
  for (int m = 0; m < 4; ++m)
    wmma::store_matrix_sync(C + 16 * m * kTcCols + 16 * w, acc[m], kTcCols,
                            wmma::mem_row_major);
}

// Stage 1 (tensor cores) on rows [r0, r0 + nr) -> c [64][h0] fp32 and hbf.
__device__ void tc_stage1(const Params<bf16>& p, const bf16* __restrict__ xpatch, int r0,
                          int nr, float* smem, const TcLayout& L) {
  using namespace psam;
  float* xs = smem + L.xs;
  float* c = smem + L.c;
  bf16* abf = reinterpret_cast<bf16*>(smem + L.abf);
  bf16* hbf = reinterpret_cast<bf16*>(smem + L.hbf);
  const int cl = pad8(p.cin);
  load_rows<bf16>(p, xpatch, r0, nr, kTcRows, xs);
  __syncthreads();
  // Dense(C_in -> h0): C_in is a handful of channels, FMA in 16-row blocks.
  for (int rb = 0; rb < kTcRows; rb += 16)
    rows_matmul<bf16, 16>(xs + rb * cl, cl, p.cin, p.w1a, p.h0, c + rb * kTcCols, kTcCols);
  __syncthreads();
  rows_epilogue<bf16>(c, kTcCols, kTcRows, p.h0, nullptr, p.b1a, p.s1, p.t1, p.tanh_act != 0,
                      abf, p.h0 + 8);
  __syncthreads();
  tile_matmul(abf, p.h0 + 8, p.h0, p.w1b, p.h0, 0, p.h0, c);
  __syncthreads();
  rows_epilogue<bf16>(c, kTcCols, kTcRows, p.h0, nullptr, p.b1b, nullptr, nullptr, false, hbf,
                      p.h0 + 8);
  __syncthreads();
}

__global__ void __launch_bounds__(kTcThreads) patch_encoder_tc_kernel(Params<bf16> p) {
  using namespace psam;
  extern __shared__ __align__(128) float smem[];
  const TcLayout L(p.cin, p.h0, p.h1, p.cout);
  const int h0 = p.h0, h1 = p.h1, cout = p.cout, ldu = h1 + 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  float* c = smem + L.c;
  bf16* hbf = reinterpret_cast<bf16*>(smem + L.hbf);
  bf16* ubf = reinterpret_cast<bf16*>(smem + L.ubf);
  float* pooled = smem + L.pooled;
  float* up_pool = smem + L.up_pool;
  float* omax = smem + L.omax;

  const int gidx = blockIdx.x, b = blockIdx.y;
  const bf16* xpatch = p.x + ((size_t)b * p.G + gidx) * p.K * p.cin;

  for (int i = threadIdx.x; i < h0; i += blockDim.x) pooled[i] = -INFINITY;
  for (int i = threadIdx.x; i < cout; i += blockDim.x) omax[i] = -INFINITY;

  // Pass 1: stage 1 and the max over K.
  for (int r0 = 0; r0 < p.K; r0 += kTcRows) {
    const int nr = min(kTcRows, p.K - r0);
    tc_stage1(p, xpatch, r0, nr, smem, L);
    for (int i = threadIdx.x; i < h0; i += blockDim.x) {
      float m = pooled[i];
      for (int r = 0; r < nr; ++r) m = fmaxf(m, c[r * kTcCols + i]);
      pooled[i] = m;
    }
    __syncthreads();
  }
  rows_matmul<bf16, 1>(pooled, h0, h0, p.w2a, h1, up_pool, h1);
  __syncthreads();

  // Pass 2: stage 1 again, stage 2, running max over K.
  for (int r0 = 0; r0 < p.K; r0 += kTcRows) {
    const int nr = min(kTcRows, p.K - r0);
    tc_stage1(p, xpatch, r0, nr, smem, L);
    // u = round(round(h @ W2a[h0:] + up_pool) + round(b2a)), in bf16 slices.
    for (int n0 = 0; n0 < h1; n0 += kTcCols) {
      const int nc = min(kTcCols, h1 - n0);
      tile_matmul(hbf, h0 + 8, h0, p.w2a + (size_t)h0 * h1, h1, n0, nc, c);
      __syncthreads();
      for (int e = threadIdx.x; e < kTcRows * kTcCols; e += blockDim.x) {
        const int r = e / kTcCols, j = e % kTcCols, col = n0 + j;
        if (j < nc)
          ubf[r * ldu + col] = __float2bfloat16_rn(
              round_to<bf16>(round_to<bf16>(c[e] + up_pool[col]) + round_to<bf16>(p.b2a[col])));
      }
      __syncthreads();
    }
    // LN -> GELU over each row of u (one warp per row, values in registers).
    for (int r = warp; r < kTcRows; r += nwarps) {
      bf16* row = ubf + r * ldu;
      float v[kMaxPerLane];
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxPerLane; ++j) {
        const int i = lane + 32 * j;
        v[j] = i < h1 ? __bfloat162float(row[i]) : 0.0f;
        s += v[j];
      }
      const float mean = warp_sum(s) / h1;
      float q = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxPerLane; ++j) {
        const float d = v[j] - mean;
        if (lane + 32 * j < h1) q += d * d;
      }
      const float inv = rsqrtf(warp_sum(q) / h1 + 1e-5f);
#pragma unroll
      for (int j = 0; j < kMaxPerLane; ++j) {
        const int i = lane + 32 * j;
        if (i < h1)
          row[i] = __float2bfloat16_rn(
              ln_gelu_value<bf16>((v[j] - mean) * inv, p.s2[i], p.t2[i], p.tanh_act != 0));
      }
    }
    __syncthreads();
    // Dense(h1 -> C_out) and the running max over the valid rows.
    for (int n0 = 0; n0 < cout; n0 += kTcCols) {
      const int nc = min(kTcCols, cout - n0);
      tile_matmul(ubf, ldu, h1, p.w2b, cout, n0, nc, c);
      __syncthreads();
      for (int j = threadIdx.x; j < nc; j += blockDim.x) {
        const float bias = round_to<bf16>(p.b2b[n0 + j]);
        float m = omax[n0 + j];
        for (int r = 0; r < nr; ++r)
          m = fmaxf(m, round_to<bf16>(round_to<bf16>(c[r * kTcCols + j]) + bias));
        omax[n0 + j] = m;
      }
      __syncthreads();
    }
  }
  for (int o = threadIdx.x; o < cout; o += blockDim.x)
    p.out[((size_t)b * p.G + gidx) * cout + o] = __float2bfloat16_rn(omax[o]);
}

template <typename T>
int launch(const Params<T>& p, int B, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (p.h0 % 16 == 0 && p.h0 <= kTcCols && p.h1 % 16 == 0 && p.cout % 16 == 0) {
      const TcLayout L(p.cin, p.h0, p.h1, p.cout);
      const size_t smem = (size_t)L.total * sizeof(float);
      cudaError_t err = cudaFuncSetAttribute(
          patch_encoder_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      patch_encoder_tc_kernel<<<dim3(p.G, B), kTcThreads, smem, stream>>>(p);
      return (int)cudaGetLastError();
    }
  }
  const Layout L(p.cin, p.h0, p.h1, p.cout);
  const size_t smem = (size_t)L.total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(patch_encoder_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  patch_encoder_kernel<T><<<dim3(p.G, B), kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* x, int B, int G, int K, int cin, const void* w1a, const void* b1a,
        const void* s1, const void* t1, const void* w1b, const void* b1b, const void* w2a,
        const void* b2a, const void* s2, const void* t2, const void* w2b, const void* b2b,
        int h0, int h1, int cout, void* out, int tanh_act, cudaStream_t stream) {
  Params<T> p;
  p.x = static_cast<const T*>(x);
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
  p.w2b = static_cast<const T*>(w2b);
  p.b2b = static_cast<const float*>(b2b);
  p.out = static_cast<T*>(out);
  p.G = G;
  p.K = K;
  p.cin = cin;
  p.h0 = h0;
  p.h1 = h1;
  p.cout = cout;
  p.tanh_act = tanh_act;
  return launch<T>(p, B, stream);
}

}  // namespace

// x [B, G*K, cin] and the weight matrices ([in, out] row-major) in the
// compute dtype (0 = float32, 1 = bfloat16); biases and LN parameters fp32;
// out [B, G, cout] in the compute dtype; h0, h1 <= 512. Weight pointers must
// be 32-byte aligned (the tensor-core loads), as fresh torch allocations are.
extern "C" int psam_patch_encoder(const void* x, int B, int G, int K, int cin,
                                  const void* w1a, const void* b1a, const void* s1,
                                  const void* t1, const void* w1b, const void* b1b,
                                  const void* w2a, const void* b2a, const void* s2,
                                  const void* t2, const void* w2b, const void* b2b, int h0,
                                  int h1, int cout, void* out, int tanh_act, int dtype,
                                  void* stream) {
  if (B <= 0 || G <= 0 || K <= 0 || cin <= 0 || h0 <= 0 || h1 <= 0 || cout <= 0 ||
      h0 > 32 * psam::kMaxPerLane || h1 > 32 * psam::kMaxPerLane)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return run<bf16>(x, B, G, K, cin, w1a, b1a, s1, t1, w1b, b1b, w2a, b2a, s2, t2, w2b, b2b,
                     h0, h1, cout, out, tanh_act, st);
  return run<float>(x, B, G, K, cin, w1a, b1a, s1, t1, w1b, b1b, w2a, b2a, s2, t2, w2b, b2b,
                    h0, h1, cout, out, tanh_act, st);
}
