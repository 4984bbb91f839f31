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
// work is ~0.36 TFLOP of bf16 products (0.37 ms at 989 TFLOP/s), ~0.34
// G GELUs (erf) and the weights (0.7 MB in bf16) streamed from L2 once per
// 64-row chunk. One block per (patch, cloud); only [C_out] per patch is
// written. The grouped input is read pre-gathered [B, G*K, C_in], as the
// JAX kernel takes it.
// - bf16 (h0, h1, C_out multiples of 16, h0 <= 128): patch_encoder_mma_kernel,
//   16 warps, every product on mma.sync.m16n8k16 (mma_tile.cuh), fp32
//   accumulators in registers, epilogues on the C fragments:
//   - stage 1 once per patch: a warp takes 16 rows; the first Dense runs
//     over C_in zero-padded to a multiple of 16 (exact), its output's LN
//     statistics reduce over the 4 lanes of a fragment row, LN -> GELU is
//     packed C-to-A into the second Dense's operand, and a2 [K, h0] stays in
//     shared memory in bf16 (exact: the reference rounds it to bf16);
//   - pooled = max over K of a2 becomes row 0 of a zero 16-row tile, so
//     up_pool = pooled W2a[:h0] runs on the tensor cores too;
//   - stage 2 over 64-row chunks of a2: u = a2 W2a[h0:] (+ up_pool, b2a on
//     the fragments) -> bf16 chunk in shared memory; LN -> GELU in place, a
//     warp per row; y = u W2b with its max over the valid rows taken on the
//     fragments (shuffles over the row groups), merged per chunk into
//     omax, written once. Warp (rg, cg) owns 32 rows x 32 columns of each
//     256-column slice;
//   - for the backward (K7), when asked: pool, and the first (smallest) row
//     at which each column of a2 and of a4 reaches its max. a2's partial
//     maxima carry their rows; a4's row is a second shuffle reduction on
//     the fragments (the smallest valid row holding the chunk's max), so no
//     (value, row) pair is carried through the accumulator loops;
//   - every weight of stage 2 streams through one ring of 64-row x
//     256-column slabs shared by all warps: two slots (2 x 33 KB), 16-byte
//     cp.async issued one slab ahead, one barrier per slab; W1a and W1b are
//     staged whole. Rows are padded by 16 bytes, so ldmatrix is free of bank
//     conflicts.
//   Shared memory at K = 256, h(128, 512) -> 512: 228,608 bytes (a2 68 KB,
//   the chunk of u 65 KB, the ring 66 KB, vectors, maxima, their rows and
//   the pooled tile 24 KB), so 1 block (16 warps, 128 registers a thread)
//   per SM: two blocks would need <= 113 KB each, less than a2 and one
//   chunk of u. A
//   longer patch needs 17 KB more per 64 rows (K <= 256 at h0 = 128,
//   h1 = 512); above the device's 227 KB the launch fails and the wrapper
//   raises.
// - otherwise (fp32, odd widths): patch_encoder_kernel, 16-row tiles and
//   plain FMA loops, stage 1 computed twice (for the max-pool, then per
//   tile of stage 2).
// The mma kernel's layout, tiling and ring were chosen on the card
// (PERF.md): 16 warps beat 8 with wider warp tiles; 64-row slabs in two slots
// beat 32-row slabs in three or four; interleaving the GELU with the W2b
// product, prefetching the next step's fragments and spreading the blocks
// over several copies of the weights (against L2 contention) did not help.
#include <type_traits>

#include "common.cuh"
#include "mma_tile.cuh"

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
  // The max-pools' first argmaxes for the backward (K7), all null or none:
  // pool [B, G, h0] = max over K of a2, arg2 [B, G, h0] and arg4 [B, G,
  // cout] the first (smallest) row at which a2 / a4 reach their maximum.
  T* pool; int* arg2; int* arg4;
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
  int xs, a, hbuf, u, y, pooled, up_pool, omax, parg, oarg, total;
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
    parg = take(h0);  // int
    oarg = take(cout);  // int
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
  int* parg = reinterpret_cast<int*>(smem + L.parg);
  int* oarg = reinterpret_cast<int*>(smem + L.oarg);

  const int gidx = blockIdx.x, b = blockIdx.y;
  const size_t patch = (size_t)b * p.G + gidx;
  const T* xpatch = p.x + patch * p.K * p.cin;

  for (int c = threadIdx.x; c < h0; c += blockDim.x) {
    pooled[c] = -INFINITY;
    parg[c] = 0;
  }
  for (int c = threadIdx.x; c < cout; c += blockDim.x) {
    omax[c] = -INFINITY;
    oarg[c] = 0;
  }

  // Pass 1: stage 1 and the max over K; the rows come in order, so a strict
  // > keeps the first maximal row.
  for (int r0 = 0; r0 < p.K; r0 += kRows) {
    const int nr = min(kRows, p.K - r0);
    stage1<T>(p, xpatch, r0, nr, smem, L);
    for (int c = threadIdx.x; c < h0; c += blockDim.x) {
      float m = pooled[c];
      int at = parg[c];
      for (int r = 0; r < nr; ++r) {
        const float v = hbuf[r * h0 + c];
        if (v > m) at = r0 + r;
        m = fmaxf(m, v);
      }
      pooled[c] = m;
      parg[c] = at;
    }
    __syncthreads();
  }
  if (p.pool)
    for (int c = threadIdx.x; c < h0; c += blockDim.x) {
      p.pool[patch * h0 + c] = from_f32<T>(pooled[c]);
      p.arg2[patch * h0 + c] = parg[c];
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
      int at = oarg[o];
      for (int r = 0; r < nr; ++r) {
        const float v = round_to<T>(round_to<T>(y[r * cout + o]) + bias);
        if (v > m) at = r0 + r;
        m = fmaxf(m, v);
      }
      omax[o] = m;
      oarg[o] = at;
    }
    __syncthreads();
  }
  for (int o = threadIdx.x; o < cout; o += blockDim.x) {
    p.out[patch * cout + o] = from_f32<T>(omax[o]);
    if (p.arg4) p.arg4[patch * cout + o] = oarg[o];
  }
}

// ------------------------------------------------------- tensor-core path
constexpr int kMmaWarps = 16;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kChunk = 64;   // stage-2 rows a chunk: 2 row groups of 32
constexpr int kSlabK = 64;   // weight rows a slab: four k16 steps
constexpr int kSlabN = 256;  // columns a slice
constexpr int kGroupN = kSlabN / (kMmaWarps / 2);  // a warp's columns of a slice
constexpr int kNt2 = kGroupN / 8;                  // its n8 tiles
constexpr int kLdSlab = kSlabN + 8;
constexpr int kStages = 2;   // slabs in the ring
constexpr int kNt1 = 16;     // n8 tiles of a stage-1 row (h0 <= 128)

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }

// Shared-memory layout in bytes, every buffer 128-byte aligned. Stage 1's
// weights and input tiles and stage 2's chunk of u share their bytes.
struct MmaLayout {
  int kp, cinp, xslots;
  size_t a2, w1a, w1b, xw, g3, ring, ptile, up, omax, oarg, vec, total;
  __host__ __device__ MmaLayout(int K, int cin, int h0, int h1, int cout) {
    kp = round_up(K, kChunk);
    cinp = round_up(cin, 16);
    // Warps that run stage 1 (each with its own input tile): at most 20 KB
    // of tiles, so that wide inputs (C_in = 131) leave room for long patches.
    const int cap = 20480 / (32 * (cinp + 8));
    xslots = imin(imin(kMmaWarps, kp / 16), cap > 1 ? cap : 1);
    size_t off = 0;
    auto take = [&](size_t bytes) {
      const size_t at = off;
      off += (bytes + 127) & ~size_t(127);
      return at;
    };
    a2 = take((size_t)kp * (h0 + 8) * 2);
    const size_t shared_at = off;
    w1a = take((size_t)cinp * (h0 + 8) * 2);
    w1b = take((size_t)h0 * (h0 + 8) * 2);
    xw = take((size_t)xslots * 16 * (cinp + 8) * 2);
    const size_t stage1_end = off;
    off = shared_at;
    g3 = take((size_t)kChunk * (h1 + 8) * 2);
    off = off > stage1_end ? off : stage1_end;
    // The max-pool's partials (kMmaThreads values and rows) use g3's bytes.
    const size_t part_end = shared_at + (size_t)2 * kMmaThreads * 4;
    off = off > part_end ? off : part_end;
    ring = take((size_t)kStages * kSlabK * kLdSlab * 2);
    ptile = take((size_t)16 * (h0 + 8) * 2);
    up = take((size_t)h1 * 4);
    omax = take((size_t)2 * cout * 4);
    oarg = take((size_t)2 * cout * 4);
    vec = take((size_t)(4 * h0 + 3 * h1 + cout) * 4);
    total = off;
  }
};

// Column pairs (n16) of a warp's column group starting at wc below n.
__device__ __forceinline__ int group_pairs(int n, int wc) {
  return min(kNt2 / 2, max(0, (n - wc) / 16));
}

__global__ void __launch_bounds__(kMmaThreads, 1) patch_encoder_mma_kernel(Params<bf16> p) {
  using namespace psam;
  extern __shared__ __align__(128) float smem[];
  unsigned char* const base = reinterpret_cast<unsigned char*>(smem);
  const MmaLayout L(p.K, p.cin, p.h0, p.h1, p.cout);
  const int K = p.K, cin = p.cin, cinp = L.cinp, h0 = p.h0, h1 = p.h1, cout = p.cout;
  const bool tanh_act = p.tanh_act != 0;
  bf16* const a2 = reinterpret_cast<bf16*>(base + L.a2);
  bf16* const w1a = reinterpret_cast<bf16*>(base + L.w1a);
  bf16* const w1b = reinterpret_cast<bf16*>(base + L.w1b);
  bf16* const xw = reinterpret_cast<bf16*>(base + L.xw);
  bf16* const g3 = reinterpret_cast<bf16*>(base + L.g3);
  bf16* const ring = reinterpret_cast<bf16*>(base + L.ring);
  bf16* const ptile = reinterpret_cast<bf16*>(base + L.ptile);
  float* const up = reinterpret_cast<float*>(base + L.up);
  float* const omax = reinterpret_cast<float*>(base + L.omax);
  int* const oarg = reinterpret_cast<int*>(base + L.oarg);
  const bool track = p.arg4 != nullptr;  // keep the first argmaxes
  // The per-column vectors, biases already rounded to bf16.
  float* const b1a = reinterpret_cast<float*>(base + L.vec);
  float* const s1 = b1a + h0;
  float* const t1 = s1 + h0;
  float* const b1b = t1 + h0;
  float* const b2a = b1b + h0;
  float* const s2 = b2a + h1;
  float* const t2 = s2 + h1;
  float* const b2b = t2 + h1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int lda = h0 + 8, ldg = h1 + 8, ldx = cinp + 8;
  const size_t patch = (size_t)blockIdx.y * p.G + blockIdx.x;
  const bf16* __restrict__ xpatch = p.x + patch * K * cin;
  const bf16 zero = __float2bfloat16_rn(0.0f);

  // Stage 2's weight slabs in the order of use: W2a[:h0] (up_pool), then
  // per row chunk W2a[h0:] and W2b, each by kSlabN-column slices of
  // kSlabK-row slabs. Slab s goes to ring slot s % kStages, kStages - 1
  // slabs ahead of its use; the cursor (weight iw, slice, k-slab) walks
  // that order.
  const int kh0 = (h0 + kSlabK - 1) / kSlabK, kh1 = (h1 + kSlabK - 1) / kSlabK;
  const int nh1 = (h1 + kSlabN - 1) / kSlabN, nout = (cout + kSlabN - 1) / kSlabN;
  const int n_slabs = nh1 * kh0 + (L.kp / kChunk) * (nh1 * kh0 + nout * kh1);
  // Thread tid copies the 16-byte chunks (rows cr + i kCopyStride, columns
  // cc..cc + 7) of each slab; entries past the weight's edge are zeroed.
  constexpr int kChunksN = kSlabN / 8, kCopyStride = kMmaThreads / kChunksN;
  static_assert(kMmaThreads % kChunksN == 0 && kSlabK % kCopyStride == 0, "slab copy");
  const int cr = tid / kChunksN, cc = (tid % kChunksN) * 8;
  const uint32_t ring_at = smem_u32(ring + cr * kLdSlab + cc);
  int is = 0, iw = 0, isl = 0, ikb = 0;
  auto issue = [&]() {
    if (is < n_slabs) {
      const bf16* W = iw == 0 ? p.w2a : iw == 1 ? p.w2a + (size_t)h0 * h1 : p.w2b;
      const int kdim = iw == 2 ? h1 : h0, n = iw == 2 ? cout : h1;
      const int k0 = ikb * kSlabK + cr, n0 = isl * kSlabN + cc;
      const bf16* src = W + (size_t)k0 * n + n0;
      const uint32_t dst = ring_at + (is % kStages) * (kSlabK * kLdSlab * 2);
#pragma unroll
      for (int i = 0; i < kSlabK / kCopyStride; ++i) {
        const bool in = n0 < n && k0 + i * kCopyStride < kdim;
        cp_async16(dst + i * (kCopyStride * kLdSlab * 2),
                   in ? src + (size_t)i * kCopyStride * n : W, in);
      }
      if (++ikb * kSlabK >= kdim) {
        ikb = 0;
        if (++isl * kSlabN >= n) {
          isl = 0;
          iw = iw == 1 ? 2 : 1;
        }
      }
    }
    cp_async_commit();
    ++is;
  };

  copy_tile_async(w1a, lda, p.w1a, h0, 0, cinp, cin, 0, h0, h0);
  copy_tile_async(w1b, lda, p.w1b, h0, 0, h0, h0, 0, h0, h0);
  cp_async_commit();
  for (int s = 0; s < kStages - 1; ++s) issue();
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
  for (int i = tid; i < cout; i += kMmaThreads) {
    b2b[i] = round_to<bf16>(p.b2b[i]);
    omax[i] = omax[cout + i] = -INFINITY;
    oarg[i] = oarg[cout + i] = K;  // no row yet
  }
  for (int i = tid; i < 16 * lda; i += kMmaThreads) ptile[i] = zero;
  for (int i = tid; i < L.xslots * 16 * ldx; i += kMmaThreads) xw[i] = zero;
  cp_async_wait<kStages - 1>();  // W1a and W1b have landed
  __syncthreads();

  // Stage 1, once per patch: each warp takes 16-row tiles; the products run
  // on registers (the first Dense's output, after LN -> GELU, is packed
  // C-to-A into the second's operand) and a2 goes to shared memory in bf16.
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
    // GELU(LN), packed C-to-A as it goes (column tiles 2 kk and 2 kk + 1 make
    // k16 step kk of the next product), so few fp32 values stay live.
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
          y[q][i] = ln_gelu_value<bf16>((acc[0][j][i] - mean[i >> 1]) * inv[i >> 1], s1[col],
                                        t1[col], tanh_act);
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
  __syncthreads();
  // pooled = max over the K valid rows of a2: kMmaThreads / h0 threads a
  // column over strided rows, then over those partial maxima; it becomes
  // row 0 of the zero tile ptile. Each partial keeps its first maximal row
  // (its rows come in order), and a tie between partials goes to the
  // smaller row. The partials lie in g3's bytes, unused until stage 2.
  {
    float* const part = reinterpret_cast<float*>(base + L.g3);
    int* const parg = reinterpret_cast<int*>(part + kMmaThreads);
    const int nq = kMmaThreads / h0, c = tid % h0, q = tid / h0;
    if (q < nq) {
      float m = -INFINITY;
      int at = K;
      for (int r = q; r < K; r += nq) {
        const float v = __bfloat162float(a2[r * lda + c]);
        if (v > m) at = r;
        m = fmaxf(m, v);
      }
      part[q * h0 + c] = m;
      parg[q * h0 + c] = at;
    }
    __syncthreads();
    for (int i = tid; i < h0; i += kMmaThreads) {
      float mx = part[i];
      int at = parg[i];
      for (int w = 1; w < nq; ++w) {
        const float v = part[w * h0 + i];
        const int r = parg[w * h0 + i];
        if (v > mx || (v == mx && r < at)) at = r;
        mx = fmaxf(mx, v);
      }
      ptile[i] = __float2bfloat16_rn(mx);
      if (track) {
        p.pool[patch * h0 + i] = ptile[i];
        p.arg2[patch * h0 + i] = at < K ? at : 0;
      }
    }
  }

  // Stage 2. Warp (rg, cg) owns rows 32 rg.. and columns kGroupN cg.. of
  // each 64-row chunk and kSlabN-column slice; one barrier per slab, after
  // which slab s + kStages - 1 is issued into the slot all warps have left.
  const int rg = warp & 1, cg = warp >> 1;
  int s = 0;
  auto next_slab = [&]() {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue();
    return ring + (s++ % kStages) * kSlabK * kLdSlab;
  };
  constexpr int kSteps = kSlabK / 16;

  // up_pool = pooled @ W2a[:h0] in fp32 on the row-group-0 warps.
  for (int sl = 0; sl < nh1; ++sl) {
    const int wc = sl * kSlabN + kGroupN * cg;
    float pacc[1][kNt2][4];
    zero_acc(pacc);
    for (int kb = 0; kb < kh0; ++kb) {
      const bf16* slab = next_slab();
      if (rg == 0)
        mma_smem<kSteps>(pacc, ptile, lda, 0, kb * kSlabK, slab, kLdSlab, 0, kGroupN * cg,
                         min(kSteps, (h0 - kb * kSlabK) / 16), group_pairs(h1, wc));
    }
    if (rg == 0 && g == 0) {
#pragma unroll
      for (int j = 0; j < kNt2; ++j) {
        const int col = wc + 8 * j + 2 * t4;
        if (col < h1) {
          up[col] = pacc[0][j][0];
          up[col + 1] = pacc[0][j][1];
        }
      }
    }
  }

  float acc[2][kNt2][4];
  for (int r0 = 0; r0 < L.kp; r0 += kChunk) {
    // u = round(round(a2 W2a[h0:] + up_pool) + round(b2a)) -> g3 in bf16.
    for (int sl = 0; sl < nh1; ++sl) {
      const int wc = sl * kSlabN + kGroupN * cg;
      zero_acc(acc);
      for (int kb = 0; kb < kh0; ++kb) {
        const bf16* slab = next_slab();
        mma_smem<kSteps>(acc, a2, lda, r0 + 32 * rg, kb * kSlabK, slab, kLdSlab, 0, kGroupN * cg,
                         min(kSteps, (h0 - kb * kSlabK) / 16), group_pairs(h1, wc));
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
            *reinterpret_cast<__nv_bfloat162*>(g3 + r * ldg + col) = __floats2bfloat162_rn(
                round_to<bf16>(round_to<bf16>(acc[m][j][2 * h] + u0) + c0),
                round_to<bf16>(round_to<bf16>(acc[m][j][2 * h + 1] + u1) + c1));
          }
      }
    }
    __syncthreads();
    // LN -> GELU over each valid row of u: one warp per row, two rows at a
    // time, a lane holding the column pairs lane + 32 j in registers; the
    // next slab's barrier publishes them.
    const int nr = min(kChunk, K - r0), npair = h1 / 2;
    for (int r = warp; r < nr; r += 2 * kMmaWarps) {
      const int nrows = r + kMmaWarps < nr ? 2 : 1;
      float v[2][kMaxPerLane], mu[2], rs[2];
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        if (w >= nrows) continue;
        const __nv_bfloat162* row =
            reinterpret_cast<const __nv_bfloat162*>(g3 + (r + w * kMmaWarps) * ldg);
        float sm = 0.0f;
#pragma unroll
        for (int j = 0; j < kMaxPerLane / 2; ++j) {
          const int i = lane + 32 * j;
          const float2 f = i < npair ? __bfloat1622float2(row[i]) : make_float2(0.0f, 0.0f);
          v[w][2 * j] = f.x;
          v[w][2 * j + 1] = f.y;
          sm += f.x + f.y;
        }
        mu[w] = warp_sum(sm) / h1;
        float q = 0.0f;
#pragma unroll
        for (int j = 0; j < kMaxPerLane / 2; ++j) {
          if (lane + 32 * j >= npair) continue;
          const float d0 = v[w][2 * j] - mu[w], d1 = v[w][2 * j + 1] - mu[w];
          q += d0 * d0 + d1 * d1;
        }
        rs[w] = rsqrtf(warp_sum(q) / h1 + 1e-5f);
      }
#pragma unroll
      for (int j = 0; j < kMaxPerLane / 2; ++j) {
        const int i = lane + 32 * j;
        if (i >= npair) continue;
        const float2 sc = reinterpret_cast<const float2*>(s2)[i];
        const float2 sh = reinterpret_cast<const float2*>(t2)[i];
#pragma unroll
        for (int w = 0; w < 2; ++w) {
          if (w >= nrows) continue;
          reinterpret_cast<__nv_bfloat162*>(g3 + (r + w * kMmaWarps) * ldg)[i] =
              __floats2bfloat162_rn(
                  ln_gelu_value<bf16>((v[w][2 * j] - mu[w]) * rs[w], sc.x, sh.x, tanh_act),
                  ln_gelu_value<bf16>((v[w][2 * j + 1] - mu[w]) * rs[w], sc.y, sh.y, tanh_act));
        }
      }
    }
    // y = round(round(g3 W2b) + round(b2b)); its max over the chunk's valid
    // rows by shuffles, merged into omax[rg] (one owner per entry). With
    // ``track``, a second reduction finds the smallest valid row that holds
    // that max; the chunks come in row order, so a later chunk takes over
    // oarg[rg] only with a larger max.
    for (int sl = 0; sl < nout; ++sl) {
      const int wc = sl * kSlabN + kGroupN * cg;
      zero_acc(acc);
      for (int kb = 0; kb < kh1; ++kb) {
        const bf16* slab = next_slab();
        mma_smem<kSteps>(acc, g3, ldg, 32 * rg, kb * kSlabK, slab, kLdSlab, 0, kGroupN * cg,
                         min(kSteps, (h1 - kb * kSlabK) / 16), group_pairs(cout, wc));
      }
#pragma unroll
      for (int j = 0; j < kNt2; ++j) {
        const int col = wc + 8 * j + 2 * t4;
        if (wc + 8 * j >= cout) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float m = -INFINITY;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (r0 + 32 * rg + 16 * mt + g + 8 * h < K)
                m = fmaxf(m, round_to<bf16>(round_to<bf16>(acc[mt][j][2 * h + e]) + b2b[col + e]));
          m = rows_max(m);
          float* const om = omax + rg * cout + col + e;
          if (track) {
            int at = K;
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int r = r0 + 32 * rg + 16 * mt + g + 8 * h;
                if (r < K &&
                    round_to<bf16>(round_to<bf16>(acc[mt][j][2 * h + e]) + b2b[col + e]) == m)
                  at = min(at, r);
              }
            at = rows_min(at);
            if (g == 0 && m > *om) oarg[rg * cout + col + e] = at;
          }
          if (g == 0) *om = fmaxf(*om, m);
        }
      }
    }
  }
  __syncthreads();
  for (int o = tid; o < cout; o += kMmaThreads) {
    const float m0 = omax[o], m1 = omax[cout + o];
    p.out[patch * cout + o] = __float2bfloat16_rn(fmaxf(m0, m1));
    if (track) {
      // Row group 1's rows interleave with group 0's by chunk: on a tie the
      // smaller row wins.
      const int a0 = oarg[o], a1 = oarg[cout + o];
      const int at = m1 > m0 || (m1 == m0 && a1 < a0) ? a1 : a0;
      p.arg4[patch * cout + o] = at < K ? at : 0;
    }
  }
}

// The most dynamic shared memory a block of the current device may use.
int smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

// Each kernel's shared-memory limit is raised to the device's maximum once,
// at its first launch (the port runs on one device); a launch that needs
// more fails and its error is returned.
template <typename T>
int launch(const Params<T>& p, int B, cudaStream_t stream) {
  static const int limit = smem_optin();
  if constexpr (std::is_same<T, bf16>::value) {
    if (p.h0 % 16 == 0 && p.h0 <= 8 * kNt1 && p.h1 % 16 == 0 && p.cout % 16 == 0) {
      static const cudaError_t attr = cudaFuncSetAttribute(
          patch_encoder_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
      if (attr != cudaSuccess) return (int)attr;
      if (!aligned16(p.w1a) || !aligned16(p.w1b) || !aligned16(p.w2a) || !aligned16(p.w2b))
        return (int)cudaErrorMisalignedAddress;
      const MmaLayout L(p.K, p.cin, p.h0, p.h1, p.cout);
      patch_encoder_mma_kernel<<<dim3(p.G, B), kMmaThreads, L.total, stream>>>(p);
      return (int)cudaGetLastError();
    }
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      patch_encoder_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (attr != cudaSuccess) return (int)attr;
  const Layout L(p.cin, p.h0, p.h1, p.cout);
  const size_t smem = (size_t)L.total * sizeof(float);
  patch_encoder_kernel<T><<<dim3(p.G, B), kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* x, int B, int G, int K, int cin, const void* w1a, const void* b1a,
        const void* s1, const void* t1, const void* w1b, const void* b1b, const void* w2a,
        const void* b2a, const void* s2, const void* t2, const void* w2b, const void* b2b,
        int h0, int h1, int cout, void* out, void* pool, void* arg2, void* arg4, int tanh_act,
        cudaStream_t stream) {
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
  p.pool = static_cast<T*>(pool);
  p.arg2 = static_cast<int*>(arg2);
  p.arg4 = static_cast<int*>(arg4);
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
// out [B, G, cout] in the compute dtype; h0, h1 <= 512. pool [B, G, h0] (the
// compute dtype), arg2 [B, G, h0] and arg4 [B, G, cout] (int32) are the
// max-pools' values and first argmaxes for the backward: all three null
// (nothing more is stored) or none. The bf16 kernel copies the weight
// matrices by 16-byte cp.async: their pointers must be 16-byte aligned, as
// fresh torch allocations are, else the call returns
// cudaErrorMisalignedAddress.
extern "C" int psam_patch_encoder(const void* x, int B, int G, int K, int cin,
                                  const void* w1a, const void* b1a, const void* s1,
                                  const void* t1, const void* w1b, const void* b1b,
                                  const void* w2a, const void* b2a, const void* s2,
                                  const void* t2, const void* w2b, const void* b2b, int h0,
                                  int h1, int cout, void* out, void* pool, void* arg2,
                                  void* arg4, int tanh_act, int dtype, void* stream) {
  if (B <= 0 || G <= 0 || K <= 0 || cin <= 0 || h0 <= 0 || h1 <= 0 || cout <= 0 ||
      h0 > 32 * psam::kMaxPerLane || h1 > 32 * psam::kMaxPerLane ||
      (pool == nullptr) != (arg2 == nullptr) || (pool == nullptr) != (arg4 == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return run<bf16>(x, B, G, K, cin, w1a, b1a, s1, t1, w1b, b1b, w2a, b2a, s2, t2, w2b, b2b,
                     h0, h1, cout, out, pool, arg2, arg4, tanh_act, st);
  return run<float>(x, B, G, K, cin, w1a, b1a, s1, t1, w1b, b1b, w2a, b2a, s2, t2, w2b, b2b,
                    h0, h1, cout, out, pool, arg2, arg4, tanh_act, st);
}
