// K1: farthest point sampling fused with the exact 3-NN interp search,
// K8: the same selection loop alone, and K9: K1 plus a binned kNN.
//
// K1 replaces point_sam_tpu/ops/fps_pallas.py::fps_interp_pallas
// (_fps_interp_kernel); K8 replaces fps_pallas (_fps_kernel), the
// selection-only FPS of the voronoi tokenizer: the same kernel with the
// best-3 state, its per-step updates and its outputs compiled out
// (template mode kSelect), so a block keeps 16 B per point instead of 40.
// K9 replaces fps_interp_knn_pallas (_fps_interp_knn_kernel), the fused
// tokenizer geometry: K1's launch on the padded cloud (its selection and
// interp), then knn_bins_kernel over the centres (see below); the top-k
// over the bins is the caller's (as in the JAX wrapper).
//
// Per batch row: G sequential selection steps from the first valid point
// (padding at -inf, max value wins, the smallest index wins ties), the
// selected centres, and for every point its 3 nearest selected centres
// (strict < over the centres in order, so equal distances keep the earlier
// slot).
//
// What bounds it on the H100: the G steps are sequential, and each needs a
// global argmax over N points, so the loop is latency-bound (one barrier
// and one cross-block exchange per step), not bandwidth-bound: a step's
// arithmetic is ~10 instructions a point. Two routes, chosen by the
// caller from N alone (ops/fps.py::fps_route):
//
// "cluster" (rows of up to kClusterPoints = 131072 points):
// fps_cluster_kernel, one thread-block cluster of C CTAs x 256 threads a
// row. One CTA where its registers hold the row (N <= 8192): no exchange
// between CTAs. Else the row spreads over 16 CTAs (the non-portable
// cluster size; a card that refuses it makes the launch fail): a step's
// arithmetic shrinks with the points a CTA holds, while the exchange
// costs about the same from 2 to 16 CTAs. Each thread holds up to 32
// points' xyz and running min distance in registers for the whole loop;
// no step reads device memory. Ranks, warps, lanes and a thread's slots
// hold increasing index ranges, so at every level a tie goes to the first
// holder, which holds the smallest index: a pick is one redux.sync max of
// order_key and one ballot, no index reduction. A step: each thread's running argmax over
// its points; the warp's pick; one slot a warp in shared memory;
// __syncthreads; the CTA's pick over its warps' slots. With C > 1, warp
// 0's first C lanes store the CTA's candidate (key, xyz: 16 B) into slot
// [rank] of every CTA of the cluster with st.async, which counts the bytes
// on that CTA's mbarrier; every warp waits on its own CTA's mbarrier for
// the C slots and picks among them, and the winning CTA writes the index.
// No cluster-wide barrier runs inside the loop: slots and mbarriers are
// double-buffered by step parity, and a CTA cannot run two steps ahead of
// a peer, since each step needs every peer's candidate of the step
// before. K1's 3-NN then runs as a second launch over all SMs, nn3.cuh's
// scan (shared with K10): the G centres through shared memory in order,
// the same d^2 and strict-< insertion as the fused loop of the grid
// route, so interp_idx / interp_d2 are bit-equal to it.
//
// "grid" (larger rows, e.g. the 524288 bucket and K9's rows above 131072
// padded points): fps_interp_kernel, one cooperative launch over point
// chunks. Each block keeps its chunk's xyz, running min distance and (K1)
// best-3 in shared memory for the whole loop; every step is a block-local
// (max, smallest index) reduction, one grid.sync(), and a deterministic
// reduction of the per-block candidates that every block does for itself.
// The loop runs G distance passes, so the last centre's distances also
// reach the best-3. A row's points must fit the shared memory of the
// co-resident blocks (40 B each: about 765k points per row on an H100 at
// B=1); beyond that the launch is refused and the wrapper raises. K8 fits
// about 1.9M points per row.
//
// K9's bins (knn_bins_kernel): the padded row of N points is the Pallas
// kernel's cell layout [8, n8], n8 = N / 8, and bin (r, l), l < l_lanes,
// holds the chunks = n8 / l_lanes points r * n8 + j * l_lanes + l. For
// centre g, cd[g, bin] is the smallest distance of the bin's members to it
// (+inf at invalid points) and ci[g, bin] that member's id, ties to the
// smallest id; an all-invalid bin gives (+inf, member 0). That is the
// Pallas kernel's per-step fold, which reads only the distance field of
// centre g and the validity, so it is a function of the centres and the
// points alone and runs after the selection. What bounds it: the G x N
// pairs' ~9 instructions each (0.27 G pairs at the serve shape), and the
// cd / ci writes (64 MB there). Design: a block takes 32 consecutive bins of
// one cell row, whose members are contiguous for each j, and stages them in
// shared memory as float4 (an invalid point at x = +inf, so its distance to
// any finite centre is +inf: the reference's mask, bit for bit), up to
// kBinTile members a bin at a time; each thread owns one bin and holds
// kBinCentres centres in registers, so one conflict-free LDS.128 of a
// member serves that many centres, and a warp's stores of one centre are 32
// consecutive words. The block's centres are a slice of the G, so the grid
// fills the card. Members are scanned in ascending j with strict <; with
// more than kBinTile members, a later tile starts from the bins that the
// thread itself wrote for the tile before.
//
// Bit-exactness: indices equal the JAX fps_xla / Pallas kernel only if d^2
// has the same bits: every kernel here computes it with nn3.cuh's sq_dist.
// The cluster route compares order_key(d) (an unsigned that orders as the
// float does; d is never -0 or NaN) where the grid route compares floats:
// the same order, so the same picks.
#include <cooperative_groups.h>
#include <climits>

#include "common.cuh"
#include "nn3.cuh"

namespace cg = cooperative_groups;

namespace {

using psam::sq_dist;

constexpr int kThreads = 512;
constexpr int kMaxBlocksPerRow = 4096;  // capacity of the candidate scratch

__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// Block-wide (max value, smallest index); every thread gets the result.
__device__ void block_argmax(float& v, int& i, float* sv, int* si) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) { sv[warp] = v; si[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    v = lane < nw ? sv[lane] : -INFINITY;
    i = lane < nw ? si[lane] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, i, off);
      if (better(ov, oi, v, i)) { v = ov; i = oi; }
    }
    if (lane == 0) { sv[0] = v; si[0] = i; }
  }
  __syncthreads();
  v = sv[0];
  i = si[0];
  __syncthreads();
}

enum Mode { kSelect = 0, kInterpMode = 1 };

template <int kMode>
__global__ void __launch_bounds__(kThreads)
fps_interp_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ valid,
                  const int* __restrict__ first, int N, int G, int chunk, int nblk,
                  int* __restrict__ idx_out, float* __restrict__ centers_out,
                  int* __restrict__ interp_idx, float* __restrict__ interp_d2,
                  float* cand_v, int* cand_i) {
  constexpr bool kInterp = kMode == kInterpMode;
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + chunk;
  float* sz = sy + chunk;
  float* smind = sz + chunk;
  float* bd0 = smind + chunk;
  float* bd1 = bd0 + chunk;
  float* bd2 = bd1 + chunk;
  int* bi0 = reinterpret_cast<int*>(bd2 + chunk);
  int* bi1 = bi0 + chunk;
  int* bi2 = bi1 + chunk;
  __shared__ float red_v[32];
  __shared__ int red_i[32];

  cg::grid_group grid = cg::this_grid();
  const int b = blockIdx.y, blk = blockIdx.x, tid = threadIdx.x;
  const int start = blk * chunk;
  const int cnt = max(0, min(chunk, N - start));
  const float* P = pts + (size_t)b * N * 3;

  for (int p = tid; p < cnt; p += blockDim.x) {
    const int n = start + p;
    sx[p] = P[3 * n];
    sy[p] = P[3 * n + 1];
    sz[p] = P[3 * n + 2];
    const bool ok = valid == nullptr || valid[(size_t)b * N + n];
    smind[p] = ok ? INFINITY : -INFINITY;
    if (kInterp) {
      bd0[p] = bd1[p] = bd2[p] = INFINITY;
      bi0[p] = bi1[p] = bi2[p] = 0;
    }
  }
  __syncthreads();

  int sel = first[b];
  for (int g = 0; g < G; ++g) {
    const float cx = P[3 * sel], cy = P[3 * sel + 1], cz = P[3 * sel + 2];
    if (blk == 0 && tid == 0) {
      idx_out[(size_t)b * G + g] = sel;
    }
    if (!kInterp && g + 1 == G) break;  // K8 needs no distance pass after the last pick
    if (kInterp && blk == 0 && tid == 0) {
      float* c = centers_out + ((size_t)b * G + g) * 3;
      c[0] = cx;
      c[1] = cy;
      c[2] = cz;
    }
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int p = tid; p < cnt; p += blockDim.x) {
      const float d = sq_dist(sx[p], sy[p], sz[p], cx, cy, cz);
      const float m = fminf(smind[p], d);
      smind[p] = m;
      if (kInterp && d < bd2[p]) {
        if (d < bd1[p]) {
          bd2[p] = bd1[p];
          bi2[p] = bi1[p];
          if (d < bd0[p]) {
            bd1[p] = bd0[p];
            bi1[p] = bi0[p];
            bd0[p] = d;
            bi0[p] = g;
          } else {
            bd1[p] = d;
            bi1[p] = g;
          }
        } else {
          bd2[p] = d;
          bi2[p] = g;
        }
      }
      if (better(m, start + p, bv, bi)) { bv = m; bi = start + p; }
    }
    if (g + 1 == G) break;  // the last pass only feeds the best-3 (K1)

    block_argmax(bv, bi, red_v, red_i);
    // Double-buffered candidates: a fast block writing step g+1 never
    // touches the buffer a slow block is still reading for step g.
    float* cv = cand_v + (size_t)(g & 1) * gridDim.y * nblk + (size_t)b * nblk;
    int* ci = cand_i + (size_t)(g & 1) * gridDim.y * nblk + (size_t)b * nblk;
    if (tid == 0) {
      __stcg(cv + blk, bv);
      __stcg(ci + blk, bi);
    }
    grid.sync();
    bv = -INFINITY;
    bi = INT_MAX;
    for (int k = tid; k < nblk; k += blockDim.x) {
      const float v = __ldcg(cv + k);  // L2 only: L1 is not coherent across SMs
      const int i = __ldcg(ci + k);
      if (better(v, i, bv, bi)) { bv = v; bi = i; }
    }
    block_argmax(bv, bi, red_v, red_i);
    sel = bi;
  }

  if (!kInterp) return;
  for (int p = tid; p < cnt; p += blockDim.x) {
    const size_t o = ((size_t)b * N + start + p) * 3;
    interp_idx[o] = bi0[p];
    interp_idx[o + 1] = bi1[p];
    interp_idx[o + 2] = bi2[p];
    interp_d2[o] = bd0[p];
    interp_d2[o + 1] = bd1[p];
    interp_d2[o + 2] = bd2[p];
  }
}

// ------------------------------------------------------------ cluster route
constexpr unsigned kFull = 0xffffffffu;
constexpr int kClusterThreads = 256;
constexpr int kRegPoints = 32;  // the most points a thread holds in registers
constexpr int kMaxCluster = 16;
// Points a row may have on the cluster route: what a 16-CTA cluster holds
// (ops/fps.py::CLUSTER_POINTS).
constexpr int kClusterPoints = kMaxCluster * kClusterThreads * kRegPoints;

// An unsigned that orders as the float does (for every float but NaN; -0
// sorts below +0, and d^2 is never -0).
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// A candidate centre: its key (0: no point), index and xyz.
struct Cand {
  unsigned key, idx;
  float x, y, z;
};

// The warp's largest key and, of the lanes that hold it, the lowest lane's
// index and xyz; every lane gets them. The lanes hold increasing index
// ranges, so the lowest lane holds the smallest index.
__device__ __forceinline__ Cand warp_pick(unsigned key, unsigned idx, float x, float y,
                                          float z) {
  const unsigned top = __reduce_max_sync(kFull, key);
  const int src = __ffs(__ballot_sync(kFull, key == top)) - 1;
  return {top, __shfl_sync(kFull, idx, src), __shfl_sync(kFull, x, src),
          __shfl_sync(kFull, y, src), __shfl_sync(kFull, z, src)};
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Every thread of the cluster arrives (release) and waits (acquire).
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" ::: "memory");
}

// The address of a shared variable in the shared memory of CTA `rank` of
// the cluster.
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}

// Store 16 bytes at `dst` of a peer CTA and count them on its mbarrier `bar`
// (both peer_addr).
__device__ __forceinline__ void push16(uint32_t dst, uint32_t bar, unsigned a, float b, float c,
                                       float d) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(dst), "r"(a), "r"(__float_as_uint(b)), "r"(__float_as_uint(c)),
      "r"(__float_as_uint(d)), "r"(bar) : "memory");
}

// Wait for the phase of parity `parity` of a local mbarrier to complete
// (acquire at cluster scope: the peers' stores are seen after it).
__device__ __forceinline__ void mbar_wait(const void* mbar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(mbar)), "r"(parity) : "memory");
  }
}

// Point n of a row (xyz; 0 where it does not exist) and its starting min
// distance: +inf, or -inf for a padded or missing point.
__device__ __forceinline__ float load_point(const float* P, const unsigned char* V, int n,
                                            bool exists, float& x, float& y, float& z) {
  x = exists ? P[3 * n] : 0.f;
  y = exists ? P[3 * n + 1] : 0.f;
  z = exists ? P[3 * n + 2] : 0.f;
  return exists && (V == nullptr || V[n]) ? INFINITY : -INFINITY;
}

// K8 (kCenters false) or K1's selection (true: also the centres), R points
// a thread in registers. Launched as gridDim = (C, B) with clusters of
// (C, 1, 1). CTA `rank` of row b holds points [rank * chunk, (rank + 1) *
// chunk); thread t of it the R points from rank * chunk + t * R on, in
// index order, in registers, their xyz also in shared memory
// ([slot][thread], for the winners' centres). Missing points sit at -inf
// and never win. Ranks, warps, lanes and slots all hold increasing index
// ranges, so at every level a tie goes to the first holder: the smallest
// index.
template <bool kCenters, int R>
__global__ void __launch_bounds__(kClusterThreads, 1)
fps_cluster_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ valid,
                   const int* __restrict__ first, int N, int G, int chunk,
                   int* __restrict__ idx_out, float* __restrict__ centers_out) {
  constexpr int T = kClusterThreads;
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + T * R;
  float* sz = sy + T * R;
  __shared__ Cand red[2][T / 32];                     // a slot a warp, by step parity
  __shared__ __align__(16) float4 slot[2][kMaxCluster];  // a slot a CTA: key bits, xyz
  __shared__ __align__(8) unsigned long long mbar[2];    // counts the slots' bytes

  const int C = gridDim.x, rank = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int base = rank * chunk, cnt = max(0, min(chunk, N - base)), first_slot = t * R;
  const float* P = pts + (size_t)b * N * 3;
  const unsigned char* V = valid == nullptr ? nullptr : valid + (size_t)b * N;

  float px[R], py[R], pz[R], pm[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int p = first_slot + k;
    pm[k] = load_point(P, V, base + p, p < cnt, px[k], py[k], pz[k]);
    sx[k * T + t] = px[k];
    sy[k * T + t] = py[k];
    sz[k * T + t] = pz[k];
  }
  if (C > 1) {
    if (t == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&mbar[0])));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&mbar[1])));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    // Every CTA of the cluster runs, with its mbarriers ready, before any push.
    cluster_barrier();
  } else {
    __syncthreads();
  }

  int sel = first[b];
  float cx = P[3 * sel], cy = P[3 * sel + 1], cz = P[3 * sel + 2];
  if (rank == 0 && t == 0) {
    idx_out[(size_t)b * G] = sel;
    if (kCenters) {
      centers_out[(size_t)b * G * 3] = cx;
      centers_out[(size_t)b * G * 3 + 1] = cy;
      centers_out[(size_t)b * G * 3 + 2] = cz;
    }
  }
  // Warp 0's lane j < C pushes into CTA j: its slot [rank] and mbarrier.
  uint32_t to_slot[2] = {0u, 0u}, to_bar[2] = {0u, 0u};
  if (C > 1 && warp == 0 && lane < C) {
    for (int q = 0; q < 2; ++q) {
      to_slot[q] = peer_addr(&slot[q][rank], lane);
      to_bar[q] = peer_addr(&mbar[q], lane);
    }
  }
  for (int g = 1; g < G; ++g) {
    // Step g's buffers and mbarrier phase: step g - 2 used them last.
    const int par = (g - 1) & 1;
    const uint32_t phase = ((g - 1) >> 1) & 1;

    // This thread's best slot: in index order, strict > keeps the first.
    float bv = 0.f;
    int bk = 0;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      pm[k] = fminf(pm[k], sq_dist(px[k], py[k], pz[k], cx, cy, cz));
      if (k == 0 || pm[k] > bv) {
        bv = pm[k];
        bk = k;
      }
    }
    // A thread without points offers key 0, below every point.
    Cand c = warp_pick(first_slot < cnt ? order_key(bv) : 0u, (unsigned)(base + first_slot + bk),
                       sx[bk * T + t], sy[bk * T + t], sz[bk * T + t]);
    if (lane == 0) red[par][warp] = c;
    __syncthreads();
    // This step's bytes, counted off the critical warp (warp 0 pushes).
    if (C > 1 && t == 32)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(smem_addr(&mbar[par])), "r"(C * 16) : "memory");
    int winner = rank;
    if (C == 1 || warp == 0) {  // the CTA's candidate
      Cand r = {0u, 0u, 0.f, 0.f, 0.f};
      if (lane < T / 32) r = red[par][lane];
      c = warp_pick(r.key, r.idx, r.x, r.y, r.z);
    }
    if (C > 1) {
      // Warp 0 pushes it into slot [rank] of every CTA; every warp waits
      // for the C slots of this step and picks among them (its idx: the
      // winning rank).
      if (warp == 0 && lane < C)
        push16(par ? to_slot[1] : to_slot[0], par ? to_bar[1] : to_bar[0], c.key, c.x, c.y, c.z);
      mbar_wait(&mbar[par], phase);
      const float4 s = lane < C ? slot[par][lane] : make_float4(0.f, 0.f, 0.f, 0.f);
      const Cand w = warp_pick(__float_as_uint(s.x), (unsigned)lane, s.y, s.z, s.w);
      winner = (int)w.idx;
      cx = w.x;
      cy = w.y;
      cz = w.z;
    } else {
      cx = c.x;
      cy = c.y;
      cz = c.z;
    }
    if (winner == rank && t == 0) {  // the winning CTA records its pick
      idx_out[(size_t)b * G + g] = (int)c.idx;
      if (kCenters) {
        float* o = centers_out + ((size_t)b * G + g) * 3;
        o[0] = cx;
        o[1] = cy;
        o[2] = cz;
      }
    }
  }
  // No CTA leaves while a peer's last push may still be landing in it.
  if (C > 1) cluster_barrier();
}

// Let `kernel` take all the shared memory a block may opt in to.
template <typename Kernel>
cudaError_t allow_max_smem(Kernel* kernel) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  const cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              optin - (int)fa.sharedSizeBytes);
}

template <bool kCenters, int R>
cudaError_t cluster_attributes() {
  auto* kernel = fps_cluster_kernel<kCenters, R>;
  const cudaError_t err = allow_max_smem(kernel);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// Once per process: every instantiation's attributes.
cudaError_t cluster_setup() {
  for (cudaError_t err : {cluster_attributes<false, 1>(), cluster_attributes<false, 2>(),
                          cluster_attributes<false, 4>(), cluster_attributes<false, 8>(),
                          cluster_attributes<false, 16>(), cluster_attributes<false, 32>(),
                          cluster_attributes<true, 1>(), cluster_attributes<true, 2>(),
                          cluster_attributes<true, 4>(), cluster_attributes<true, 8>(),
                          cluster_attributes<true, 16>(), cluster_attributes<true, 32>()})
    if (err != cudaSuccess) return err;
  return cudaSuccess;
}

template <bool kCenters, int R>
cudaError_t launch_cluster_r(const cudaLaunchConfig_t& cfg, const void* pts, const void* valid,
                             const void* first, int N, int G, int chunk, void* idx_out,
                             void* centers_out) {
  return cudaLaunchKernelEx(&cfg, fps_cluster_kernel<kCenters, R>, static_cast<const float*>(pts),
                            static_cast<const unsigned char*>(valid),
                            static_cast<const int*>(first), N, G, chunk,
                            static_cast<int*>(idx_out), static_cast<float*>(centers_out));
}

template <bool kCenters>
int launch_cluster(const void* pts, const void* valid, const void* first, int B, int N, int G,
                   void* idx_out, void* centers_out, void* stream) {
  if (B <= 0 || N <= 0 || G <= 0 || N > kClusterPoints) return (int)cudaErrorInvalidValue;
  static const cudaError_t setup = cluster_setup();
  if (setup != cudaSuccess) return (int)setup;
  constexpr int T = kClusterThreads;
  // One CTA where its registers hold the row: then no exchange between CTAs
  // at all. Else the row spread over 16 CTAs: a step's arithmetic shrinks
  // with the points a CTA holds, and the exchange costs about the same from
  // 2 to 16 CTAs. R: the thread's points, rounded up to a power of two.
  const int C = N <= T * kRegPoints ? 1 : kMaxCluster;
  const int chunk = (N + C - 1) / C;
  const int per_thread = (chunk + T - 1) / T;
  int R = 1;
  while (R < per_thread) R *= 2;

  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, B);
  cfg.blockDim = dim3(T);
  cfg.dynamicSmemBytes = sizeof(float) * 3 * T * R;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  switch (R) {
    case 1: err = launch_cluster_r<kCenters, 1>(cfg, pts, valid, first, N, G, chunk,
                                                idx_out, centers_out); break;
    case 2: err = launch_cluster_r<kCenters, 2>(cfg, pts, valid, first, N, G, chunk,
                                                idx_out, centers_out); break;
    case 4: err = launch_cluster_r<kCenters, 4>(cfg, pts, valid, first, N, G, chunk,
                                                idx_out, centers_out); break;
    case 8: err = launch_cluster_r<kCenters, 8>(cfg, pts, valid, first, N, G, chunk,
                                                idx_out, centers_out); break;
    case 16: err = launch_cluster_r<kCenters, 16>(cfg, pts, valid, first, N, G, chunk,
                                                  idx_out, centers_out); break;
    default: err = launch_cluster_r<kCenters, 32>(cfg, pts, valid, first, N, G, chunk,
                                                  idx_out, centers_out);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- grid route
template <int kMode>
int launch(const void* pts, const void* valid, const void* first, int B, int N, int G,
           void* idx_out, void* centers_out, void* interp_idx, void* interp_d2, void* cand_v,
           void* cand_i, void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (B <= 0 || N <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  int nblk = (N + kThreads - 1) / kThreads;
  nblk = max(1, min(nblk, sms / B));
  int chunk = (N + nblk - 1) / nblk;
  const int words = kMode == kSelect ? 4 : 10;
  const size_t smem = (size_t)chunk * words * sizeof(float);
  auto* kernel = fps_interp_kernel<kMode>;
  static const cudaError_t attr = allow_max_smem(kernel);
  if (attr != cudaSuccess) return (int)attr;
  int occ = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (nblk > kMaxBlocksPerRow || (long long)occ * sms < (long long)nblk * B)
    return (int)cudaErrorCooperativeLaunchTooLarge;

  const float* p_pts = static_cast<const float*>(pts);
  const unsigned char* p_valid = static_cast<const unsigned char*>(valid);
  const int* p_first = static_cast<const int*>(first);
  int* p_idx = static_cast<int*>(idx_out);
  float* p_ctr = static_cast<float*>(centers_out);
  int* p_iidx = static_cast<int*>(interp_idx);
  float* p_id2 = static_cast<float*>(interp_d2);
  float* p_cv = static_cast<float*>(cand_v);
  int* p_ci = static_cast<int*>(cand_i);
  void* args[] = {&p_pts, &p_valid, &p_first, &N, &G, &chunk, &nblk,
                  &p_idx, &p_ctr, &p_iidx, &p_id2, &p_cv, &p_ci};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(nblk, B), dim3(kThreads), args,
                                    smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ K9 bins
constexpr int kBinThreads = 128;  // 4 warps, all on the block's 32 bins
constexpr int kBinCentres = 8;    // centres a thread holds in registers
constexpr int kBinTile = 64;      // members a bin staged at a time: 32 KB
constexpr int kBinWarps = kBinThreads / 32;

// Bins [32 * blockIdx.x, + 32) (one cell row; l_lanes % 32 == 0) against
// centres [per_block * blockIdx.y, + per_block) of row blockIdx.z (see the
// header). Warp w takes centres w * kBinCentres, + kBinCentres, then every
// kBinWarps * kBinCentres-th on; lane l owns bin 32 * blockIdx.x + l.
__global__ void __launch_bounds__(kBinThreads)
knn_bins_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ valid,
                const float* __restrict__ centers, int N, int G, int l_lanes, int per_block,
                float* __restrict__ cd, int* __restrict__ ci) {
  constexpr int T = kBinCentres;
  __shared__ float4 sm[kBinTile][32];
  const int b = blockIdx.z, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n8 = N / 8, chunks = n8 / l_lanes, nbins = 8 * l_lanes;
  const int bin0 = blockIdx.x * 32, r = bin0 / l_lanes, l0 = bin0 % l_lanes;
  const int c_begin = (int)blockIdx.y * per_block, c_end = min(G, c_begin + per_block);
  const float* P = pts + (size_t)b * N * 3;
  const unsigned char* V = valid == nullptr ? nullptr : valid + (size_t)b * N;
  const float* C = centers + (size_t)b * G * 3;
  const int base = r * n8 + l0 + lane;  // the id of member 0 of this lane's bin

  for (int j0 = 0; j0 < chunks; j0 += kBinTile) {
    const int m = min(kBinTile, chunks - j0);
    if (j0 > 0) __syncthreads();  // every warp is done with the last tile
    for (int e = threadIdx.x; e < m * 32; e += kBinThreads) {
      const int n = r * n8 + (j0 + (e >> 5)) * l_lanes + l0 + (e & 31);
      const bool ok = V == nullptr || V[n];
      sm[e >> 5][e & 31] = make_float4(ok ? P[3 * n] : INFINITY, P[3 * n + 1], P[3 * n + 2], 0.f);
    }
    __syncthreads();
    for (int c0 = c_begin + warp * T; c0 < c_end; c0 += kBinWarps * T) {
      float cx[T], cy[T], cz[T], bv[T];
      int bi[T];
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const int c = min(c0 + t, c_end - 1);  // a short last group repeats a centre
        cx[t] = C[3 * c];
        cy[t] = C[3 * c + 1];
        cz[t] = C[3 * c + 2];
        const size_t o = ((size_t)b * G + c) * nbins + bin0 + lane;
        // The first tile starts at (+inf, member 0), so an all-invalid bin
        // keeps member 0's id; a later one from this thread's own stores.
        bv[t] = j0 == 0 ? INFINITY : cd[o];
        bi[t] = j0 == 0 ? base : ci[o];
      }
      for (int j = 0; j < m; ++j) {
        const float4 p = sm[j][lane];
        const int id = base + (j0 + j) * l_lanes;
#pragma unroll
        for (int t = 0; t < T; ++t) {
          const float d = sq_dist(p.x, p.y, p.z, cx[t], cy[t], cz[t]);
          if (d < bv[t]) {
            bv[t] = d;
            bi[t] = id;
          }
        }
      }
#pragma unroll
      for (int t = 0; t < T; ++t) {
        if (c0 + t >= c_end) break;
        const size_t o = ((size_t)b * G + c0 + t) * nbins + bin0 + lane;
        cd[o] = bv[t];
        ci[o] = bi[t];
      }
    }
  }
}

}  // namespace

// pts [B, N, 3] f32; valid [B, N] uint8 or NULL; first [B] int32 (first
// valid index per row); cluster 1 (the cluster route: N <= 131072, then
// cand_v / cand_i may be NULL) or 0 (the grid route); outputs idx [B, G]
// int32, centers [B, G, 3] f32, interp_idx [B, N, 3] int32, interp_d2
// [B, N, 3] f32; cand_v / cand_i are the grid route's scratch of
// 2 * B * 4096 entries each.
extern "C" int psam_fps_interp(const void* pts, const void* valid, const void* first, int B,
                               int N, int G, int cluster, void* idx_out, void* centers_out,
                               void* interp_idx, void* interp_d2, void* cand_v, void* cand_i,
                               void* stream) {
  if (!cluster)
    return launch<kInterpMode>(pts, valid, first, B, N, G, idx_out, centers_out, interp_idx,
                               interp_d2, cand_v, cand_i, stream);
  const int err =
      launch_cluster<true>(pts, valid, first, B, N, G, idx_out, centers_out, stream);
  if (err != 0) return err;
  return psam::launch_nn3<false>(pts, centers_out, B, N, G, 0.f, interp_idx, interp_d2, stream);
}

// K8: the selection alone. Same arguments as psam_fps_interp without the
// centres and the 3-NN outputs; idx [B, G] int32.
extern "C" int psam_fps(const void* pts, const void* valid, const void* first, int B, int N,
                        int G, int cluster, void* idx_out, void* cand_v, void* cand_i,
                        void* stream) {
  if (cluster)
    return launch_cluster<false>(pts, valid, first, B, N, G, idx_out, nullptr, stream);
  return launch<kSelect>(pts, valid, first, B, N, G, idx_out, nullptr, nullptr, nullptr,
                         cand_v, cand_i, stream);
}

// K9's bins (knn_bins_kernel): pts [B, N, 3] f32 with N a multiple of
// 8 * l_lanes and l_lanes a multiple of 32; valid [B, N] uint8 or NULL;
// centers [B, G, 3] f32; outputs cd [B, G, 8 * l_lanes] f32 and ci
// [B, G, 8 * l_lanes] int32, each centre's bin minima and their point ids.
extern "C" int psam_knn_bins(const void* pts, const void* valid, const void* centers, int B,
                             int N, int G, int l_lanes, void* cd, void* ci, void* stream) {
  if (B <= 0 || G <= 0 || l_lanes <= 0 || l_lanes % 32 || N <= 0 || N % (8 * l_lanes))
    return (int)cudaErrorInvalidValue;
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  // Split the centres until the grid holds about 16 blocks an SM (a finer
  // spread evens out the last wave), in slices of whole warp groups.
  constexpr int kGroup = kBinWarps * kBinCentres;
  const int groups = 8 * l_lanes / 32;
  const long long rows = (long long)B * groups;
  const int want = (int)((16LL * sms + rows - 1) / rows);
  const int splits = max(1, min(want, (G + kGroup - 1) / kGroup));
  const int per_block = ((G + splits - 1) / splits + kGroup - 1) / kGroup * kGroup;
  const dim3 grid(groups, (G + per_block - 1) / per_block, B);
  knn_bins_kernel<<<grid, kBinThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const unsigned char*>(valid),
      static_cast<const float*>(centers), N, G, l_lanes, per_block, static_cast<float*>(cd),
      static_cast<int*>(ci));
  return (int)cudaGetLastError();
}
