// K1: farthest point sampling fused with the exact 3-NN interp search.
//
// Replaces point_sam_tpu/ops/fps_pallas.py::fps_interp_pallas
// (_fps_interp_kernel). Per batch row: G sequential selection steps from the
// first valid point (padding at -inf, max value wins, the smallest index
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
// refused and the wrapper raises.
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

__global__ void __launch_bounds__(kThreads)
fps_interp_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ valid,
                  const int* __restrict__ first, int N, int G, int chunk, int nblk,
                  int* __restrict__ idx_out, float* __restrict__ centers_out,
                  int* __restrict__ interp_idx, float* __restrict__ interp_d2,
                  float* cand_v, int* cand_i) {
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
    bd0[p] = bd1[p] = bd2[p] = INFINITY;
    bi0[p] = bi1[p] = bi2[p] = 0;
  }
  __syncthreads();

  int sel = first[b];
  for (int g = 0; g < G; ++g) {
    const float cx = P[3 * sel], cy = P[3 * sel + 1], cz = P[3 * sel + 2];
    if (blk == 0 && tid == 0) {
      idx_out[(size_t)b * G + g] = sel;
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
      if (d < bd2[p]) {
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
    if (g + 1 == G) break;  // the last pass only feeds the best-3

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

}  // namespace

// pts [B, N, 3] f32; valid [B, N] uint8 or NULL; first [B] int32 (first
// valid index per row); outputs idx [B, G] int32, centers [B, G, 3] f32,
// interp_idx [B, N, 3] int32, interp_d2 [B, N, 3] f32; cand_v / cand_i are
// scratch of 2 * B * 4096 entries each.
extern "C" int psam_fps_interp(const void* pts, const void* valid, const void* first, int B,
                               int N, int G, void* idx_out, void* centers_out,
                               void* interp_idx, void* interp_d2, void* cand_v, void* cand_i,
                               void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (B <= 0 || N <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  int nblk = (N + kThreads - 1) / kThreads;
  nblk = max(1, min(nblk, sms / B));
  int chunk = (N + nblk - 1) / nblk;
  const size_t smem = (size_t)chunk * 10 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fps_interp_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fps_interp_kernel, kThreads, smem);
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
  err = cudaLaunchCooperativeKernel((const void*)fps_interp_kernel, dim3(nblk, B),
                                    dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
