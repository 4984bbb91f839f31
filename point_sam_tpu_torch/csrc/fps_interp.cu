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
// Per batch row: G sequential selection steps from the first valid point (padding at -inf, max value wins, the smallest index
// wins ties), the selected centres, and for every point its 3 nearest
// selected centres (running best-3 over the distance fields the selection
// loop computes anyway; strict < so equal distances keep the earlier slot).
//
// What bounds it on the H100: the G steps are sequential, and each needs a
// global argmax over N points, so the kernel is latency-bound (one grid-wide
// barrier per step), not bandwidth-bound: 131072 points x 40 B of state fit
// in the shared memory of the 132 SMs.
// Design: one cooperative launch over point chunks. Each block keeps its
// chunk's xyz, running min-distance and best-3 in shared memory for the
// whole loop; every step is a block-local (max, smallest index) reduction,
// one grid.sync(), and a deterministic reduction of the per-block
// candidates that every block does for itself. The loop runs G distance
// passes, so the last centre's distances also reach the best-3. A row's
// points must fit the shared memory of the co-resident blocks (40 B each:
// about 765k points per row on an H100 at B=1); beyond that the launch is
// refused and the wrapper raises. K8 fits about 1.9M points per row.
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
// fma(dz, dz, fma(dx, dx, dy * dy)); the kernel writes exactly that with _rn
// intrinsics, which nvcc never re-associates or contracts differently.
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
      const float dx = __fsub_rn(sx[p], cx);
      const float dy = __fsub_rn(sy[p], cy);
      const float dz = __fsub_rn(sz[p], cz);
      const float d = __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
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
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, smem);
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
// valid index per row); outputs idx [B, G] int32, centers [B, G, 3] f32,
// interp_idx [B, N, 3] int32, interp_d2 [B, N, 3] f32; cand_v / cand_i are
// scratch of 2 * B * 4096 entries each.
extern "C" int psam_fps_interp(const void* pts, const void* valid, const void* first, int B,
                               int N, int G, void* idx_out, void* centers_out,
                               void* interp_idx, void* interp_d2, void* cand_v, void* cand_i,
                               void* stream) {
  return launch<kInterpMode>(pts, valid, first, B, N, G, idx_out, centers_out, interp_idx,
                             interp_d2, cand_v, cand_i, Bins{}, stream);
}

// K8: the selection alone. Same arguments as psam_fps_interp without the
// centres and the 3-NN outputs; idx [B, G] int32.
extern "C" int psam_fps(const void* pts, const void* valid, const void* first, int B, int N,
                        int G, void* idx_out, void* cand_v, void* cand_i, void* stream) {
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
