// K1: farthest point sampling fused with the exact 3-NN interp search,
// K8: the same selection loop alone, and K9: K1 plus a binned kNN fold.
//
// K1 replaces point_sam_tpu/ops/fps_pallas.py::fps_interp_pallas
// (_fps_interp_kernel); K8 replaces fps_pallas (_fps_kernel), the
// selection-only FPS of the voronoi tokenizer: the same kernel with the
// best-3 state, its per-step updates and its outputs compiled out
// (template mode kSelect), so a block keeps 16 B per point instead of 40.
// K9 replaces fps_interp_knn_pallas (_fps_interp_knn_kernel), the fused
// tokenizer geometry: K1's selection and interp, bit for bit, and at every
// step the masked distance field of that step's centre folded into
// 8 * l_lanes bins (point n of the n_pad-point row lies in bin
// (n / n8, (n % n8) % l_lanes), n8 = n_pad / 8): per bin the smallest
// distance, ties to the smallest point id, padded and invalid points at
// +inf. cd / ci [B, G, 8 * l_lanes] receive each step's bins; the top-k
// over them is the caller's (as in the JAX wrapper).
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
// "cluster" (K1 and K8 for rows of up to kClusterPoints = 131072 points):
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
// before. K1's 3-NN then runs as a second launch over all SMs,
// fps_nn3_kernel: one thread a point, the G centres through shared memory
// in order, the same d^2 and strict-< insertion as the fused loop, so
// interp_idx / interp_d2 are bit-equal to it.
//
// "grid" (larger rows, e.g. the 524288 bucket; and K9 always):
// fps_interp_kernel, one cooperative launch over point chunks. Each block
// keeps its chunk's xyz, running min distance and (K1, K9) best-3 in shared
// memory for the whole loop; every step is a block-local (max, smallest
// index) reduction, one grid.sync(), and a deterministic reduction of the
// per-block candidates that every block does for itself. The loop runs G
// distance passes, so the last centre's distances also reach the best-3.
// A row's points must fit the shared memory of the co-resident blocks (40
// B each: about 765k points per row on an H100 at B=1); beyond that the
// launch is refused and the wrapper raises. K8 fits about 1.9M points per
// row.
//
// K9's fold: a bin's members lie l_lanes points apart, across K1's
// contiguous chunks, so K9 hands each block whole bins instead (its points
// are the members of bins [blk * bpb, (blk + 1) * bpb), slot q * chunks + j
// holding member j of local bin q) and keeps every slot's original id: the
// fold is then block-local (one warp per bin, shuffles), with no atomics,
// and the argmax still breaks ties on original ids. Two more words per
// point (the masked field and the id): 48 B.
//
// Bit-exactness: indices equal the JAX fps_xla / Pallas kernel only if d^2
// has the same bits. XLA compiles the reference's (dx^2 + dy^2) + dz^2 into
// fma(dz, dz, fma(dx, dx, dy * dy)); the kernels write exactly that with _rn
// intrinsics (sq_dist), which nvcc never re-associates or contracts
// differently. The cluster route compares order_key(d) (an unsigned that
// orders as the float does; d is never -0 or NaN) where the grid route
// compares floats: the same order, so the same picks.
#include <cooperative_groups.h>
#include <climits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kMaxBlocksPerRow = 4096;  // capacity of the candidate scratch

__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// d^2 of a point to a centre with the reference's bits (see the header).
__device__ __forceinline__ float sq_dist(float x, float y, float z, float cx, float cy,
                                         float cz) {
  const float dx = __fsub_rn(x, cx);
  const float dy = __fsub_rn(y, cy);
  const float dz = __fsub_rn(z, cz);
  return __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
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

enum Mode { kSelect = 0, kInterpMode = 1, kKnnMode = 2 };

// K9's bin layout: n8 = n_pad / 8 points per row of the cell layout,
// l_lanes bins per row, chunks = n8 / l_lanes members per bin, bpb bins per
// block, nbins = 8 * l_lanes.
struct Bins {
  int n8, l_lanes, chunks, bpb, nbins;
  float* cd;
  int* ci;
};

// Lexicographic (distance, id) minimum of a warp; every lane gets it.
__device__ __forceinline__ void warp_argmin(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (ov < v || (ov == v && oi < i)) { v = ov; i = oi; }
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
fps_interp_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ valid,
                  const int* __restrict__ first, int N, int G, int chunk, int nblk,
                  int* __restrict__ idx_out, float* __restrict__ centers_out,
                  int* __restrict__ interp_idx, float* __restrict__ interp_d2,
                  float* cand_v, int* cand_i, Bins bins) {
  constexpr bool kInterp = kMode != kSelect;
  constexpr bool kKnn = kMode == kKnnMode;
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
  float* sdm = reinterpret_cast<float*>(bi2 + chunk);  // K9: masked field
  int* sid = reinterpret_cast<int*>(sdm + chunk);     // K9: original ids
  __shared__ float red_v[32];
  __shared__ int red_i[32];

  cg::grid_group grid = cg::this_grid();
  const int b = blockIdx.y, blk = blockIdx.x, tid = threadIdx.x;
  const int start = blk * chunk;
  const int bin0 = blk * bins.bpb;
  const int cnt = kKnn ? max(0, min(bins.bpb, bins.nbins - bin0)) * bins.chunks
                       : max(0, min(chunk, N - start));
  const float* P = pts + (size_t)b * N * 3;

  for (int p = tid; p < cnt; p += blockDim.x) {
    int n = start + p;
    if (kKnn) {
      const int bin = bin0 + p / bins.chunks, j = p % bins.chunks;
      n = (bin / bins.l_lanes) * bins.n8 + j * bins.l_lanes + bin % bins.l_lanes;
      sid[p] = n;
    }
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
      const int id = kKnn ? sid[p] : start + p;
      if (kKnn) sdm[p] = smind[p] == -INFINITY ? INFINITY : d;  // invalid: +inf
      if (better(m, id, bv, bi)) { bv = m; bi = id; }
    }
    if (kKnn) {
      // The fold of centre g: one warp per bin, lanes over its members.
      __syncthreads();
      const int lane = tid & 31, nb = cnt / bins.chunks;
      for (int q = tid >> 5; q < nb; q += blockDim.x >> 5) {
        float v = INFINITY;
        int i = INT_MAX;
        for (int j = lane; j < bins.chunks; j += 32) {
          const float dv = sdm[q * bins.chunks + j];
          const int di = sid[q * bins.chunks + j];
          if (dv < v || (dv == v && di < i)) { v = dv; i = di; }
        }
        warp_argmin(v, i);
        if (lane == 0) {
          const size_t o = ((size_t)b * G + g) * bins.nbins + bin0 + q;
          bins.cd[o] = v;
          bins.ci[o] = i;
        }
      }
    }
    if (g + 1 == G) break;  // the last pass only feeds the best-3 (K1, K9)

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
    const size_t o = ((size_t)b * N + (kKnn ? sid[p] : start + p)) * 3;
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

// K1's 3-NN on the cluster route: every point's 3 nearest of the G centres,
// in centre order with strict <, as the fused loop of the grid route keeps
// them. One thread a point; the centres pass through shared memory in
// tiles of kNnTile.
constexpr int kNnThreads = 256;
constexpr int kNnTile = 2048;

__global__ void __launch_bounds__(kNnThreads)
fps_nn3_kernel(const float* __restrict__ pts, const float* __restrict__ centers, int N, int G,
               int* __restrict__ interp_idx, float* __restrict__ interp_d2) {
  __shared__ float4 sc[kNnTile];
  const int b = blockIdx.y, n = blockIdx.x * kNnThreads + threadIdx.x;
  const float* P = pts + (size_t)b * N * 3;
  const float* Cb = centers + (size_t)b * G * 3;
  float x = 0.f, y = 0.f, z = 0.f;
  if (n < N) {
    x = P[3 * n];
    y = P[3 * n + 1];
    z = P[3 * n + 2];
  }
  float bd0 = INFINITY, bd1 = INFINITY, bd2 = INFINITY;
  int bi0 = 0, bi1 = 0, bi2 = 0;
  for (int g0 = 0; g0 < G; g0 += kNnTile) {
    const int m = min(kNnTile, G - g0);
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += kNnThreads) {
      const float* c = Cb + (size_t)(g0 + i) * 3;
      sc[i] = make_float4(c[0], c[1], c[2], 0.f);
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < m; ++i) {
      const float4 c = sc[i];
      const float d = sq_dist(x, y, z, c.x, c.y, c.z);
      if (d < bd2) {
        const int g = g0 + i;
        if (d < bd1) {
          bd2 = bd1;
          bi2 = bi1;
          if (d < bd0) {
            bd1 = bd0;
            bi1 = bi0;
            bd0 = d;
            bi0 = g;
          } else {
            bd1 = d;
            bi1 = g;
          }
        } else {
          bd2 = d;
          bi2 = g;
        }
      }
    }
  }
  if (n >= N) return;
  const size_t o = ((size_t)b * N + n) * 3;
  interp_idx[o] = bi0;
  interp_idx[o + 1] = bi1;
  interp_idx[o + 2] = bi2;
  interp_d2[o] = bd0;
  interp_d2[o + 1] = bd1;
  interp_d2[o + 2] = bd2;
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

int launch_nn3(const void* pts, const void* centers, int B, int N, int G, void* interp_idx,
               void* interp_d2, void* stream) {
  fps_nn3_kernel<<<dim3((N + kNnThreads - 1) / kNnThreads, B), kNnThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(centers), N, G,
      static_cast<int*>(interp_idx), static_cast<float*>(interp_d2));
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- grid route
template <int kMode>
int launch(const void* pts, const void* valid, const void* first, int B, int N, int G,
           void* idx_out, void* centers_out, void* interp_idx, void* interp_d2, void* cand_v,
           void* cand_i, Bins bins, void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (B <= 0 || N <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  int nblk = (N + kThreads - 1) / kThreads;
  nblk = max(1, min(nblk, sms / B));
  int chunk = (N + nblk - 1) / nblk;
  if (kMode == kKnnMode) {  // whole bins per block
    bins.bpb = (bins.nbins + nblk - 1) / nblk;
    nblk = (bins.nbins + bins.bpb - 1) / bins.bpb;
    chunk = bins.bpb * bins.chunks;
  }
  const int words = kMode == kSelect ? 4 : kMode == kInterpMode ? 10 : 12;
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
                  &p_idx, &p_ctr, &p_iidx, &p_id2, &p_cv, &p_ci, &bins};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(nblk, B), dim3(kThreads), args,
                                    smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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
                               interp_d2, cand_v, cand_i, Bins{}, stream);
  const int err =
      launch_cluster<true>(pts, valid, first, B, N, G, idx_out, centers_out, stream);
  if (err != 0) return err;
  return launch_nn3(pts, centers_out, B, N, G, interp_idx, interp_d2, stream);
}

// K8: the selection alone. Same arguments as psam_fps_interp without the
// centres and the 3-NN outputs; idx [B, G] int32.
extern "C" int psam_fps(const void* pts, const void* valid, const void* first, int B, int N,
                        int G, int cluster, void* idx_out, void* cand_v, void* cand_i,
                        void* stream) {
  if (cluster)
    return launch_cluster<false>(pts, valid, first, B, N, G, idx_out, nullptr, stream);
  return launch<kSelect>(pts, valid, first, B, N, G, idx_out, nullptr, nullptr, nullptr,
                         cand_v, cand_i, Bins{}, stream);
}

// K9: psam_fps_interp's arguments and outputs, with N a multiple of
// 8 * l_lanes (the caller pads, its padding invalid) and l_lanes a
// multiple of 32, plus cd [B, G, 8 * l_lanes] f32 and ci [B, G, 8 * l_lanes]
// int32, each step's bin minima and their point ids.
extern "C" int psam_fps_interp_knn(const void* pts, const void* valid, const void* first,
                                   int B, int N, int G, int l_lanes, void* idx_out,
                                   void* centers_out, void* interp_idx, void* interp_d2,
                                   void* cd, void* ci, void* cand_v, void* cand_i,
                                   void* stream) {
  if (l_lanes <= 0 || N % (8 * l_lanes)) return (int)cudaErrorInvalidValue;
  Bins bins;
  bins.n8 = N / 8;
  bins.l_lanes = l_lanes;
  bins.chunks = bins.n8 / l_lanes;
  bins.nbins = 8 * l_lanes;
  bins.bpb = 0;  // set by launch
  bins.cd = static_cast<float*>(cd);
  bins.ci = static_cast<int*>(ci);
  return launch<kKnnMode>(pts, valid, first, B, N, G, idx_out, centers_out, interp_idx,
                          interp_d2, cand_v, cand_i, bins, stream);
}
