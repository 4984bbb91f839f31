// K12: the k nearest keys of every query, exact or over strided bins.
//
// Replaces no pallas_call: it is the card's counterpart of the two XLA
// selections of point_sam_tpu/ops/knn.py, ``lax.top_k`` (:32, :284; the
// exact search, JAX ``knn(method="exact")``) and ``lax.approx_min_k``
// (:161; JAX ``knn(method="approx")``, which the TPU takes for the
// tokenizer's G x K search). Its plain version is
// point_sam_tpu_torch/ops/knn.py::knn_select_plain, and every output equals
// it bit for bit:
//
// - d^2 = max((q2 - 2 dot) + k2, +0) with q2, k2 and dot each
//   fma(z, z', fma(y, y', x * x')) (__fmaf_rn / __fmul_rn / __fadd_rn /
//   __fsub_rn, so nvcc contracts nothing else); an invalid key is +inf;
// - a candidate is the 64-bit key (bits(d^2) << 32) | index: d^2 >= +0, so
//   the bits order as the values and ties go to the smaller index;
// - exact mode: the k smallest keys; approximate mode (bins = L): the
//   smallest key of each strided bin {i : i mod L == j}, an empty bin
//   holding (+inf, Nk + j), then the k smallest of the L bin minima; an
//   index >= Nk is reported as Nk - 1.
//
// One block of 256 threads a (batch, query) row; the keys are read through
// L2 (the 131072 x 3 fp32 cloud is 1.5 MB). The selection of the k
// smallest of n keys (the keys computed again on every pass, or the bins in
// shared memory): n <= 2048 are sorted whole; otherwise a strided sample of
// 2048 keys is sorted, its r-th key (r about the k-th key's expected rank
// in the sample plus 3 sigma and 3) bounds the candidates, one pass
// appends every key at or below it to a 2048-entry buffer (a ballot and
// one shared atomic a warp), and the buffer is sorted (bitonic) when it
// holds between k and 2048. Where the sample misjudged, a radix select on
// the 64-bit key (8 bits a pass, a shared histogram) narrows the bound
// until every key below it fits, and the pass is made again.
//
// What bounds it on the H100: about 8 fp32 operations a (query, key) pair
// (0.032 ms at 2048 x 131072 at 67 TFLOP/s); the keys a block reads come
// from L2 once a pass, 2 passes in the usual case (the sample is small).
// The approximate mode's bins live in shared memory (8 bytes a bin; up to
// 26624 bins with the 227 KB a block may opt into).
#include "common.cuh"

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 256;
constexpr int kCap = 2048;     // candidates a block sorts at most
constexpr int kSample = 2048;  // keys the bound is estimated from
constexpr int kMaxK = 1024;
constexpr int kMaxBins = 26624;
constexpr int kUnroll = 4;     // keys a thread computes before their ballots
constexpr u64 kInfKey = u64(0x7f800000u) << 32;
constexpr u64 kPad = ~0ull;    // above every key: pads a sort, ends a pass
constexpr size_t kFixedSmem = kCap * sizeof(u64) + 256 * sizeof(int) + 4 * sizeof(int);

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  return __fmaf_rn(az, bz, __fmaf_rn(ay, by, __fmul_rn(ax, bx)));
}

// The packed keys of one query against the keys of its batch row.
struct KeySource {
  float qx, qy, qz, q2;
  const float* key;
  const unsigned char* valid;

  __device__ __forceinline__ u64 operator()(int i) const {
    float d2 = INFINITY;
    if (valid == nullptr || __ldg(valid + i)) {
      const float kx = __ldg(key + 3 * i), ky = __ldg(key + 3 * i + 1),
                  kz = __ldg(key + 3 * i + 2);
      const float k2 = dot3(kx, ky, kz, kx, ky, kz);
      const float dot = dot3(qx, qy, qz, kx, ky, kz);
      const float s = __fadd_rn(__fsub_rn(q2, __fmul_rn(2.0f, dot)), k2);
      d2 = s > 0.0f ? s : 0.0f;  // -0 and NaN become +0, as the plain version's where()
    }
    return (u64(__float_as_uint(d2)) << 32) | unsigned(i);
  }
};

// The bin minima in shared memory.
struct BinSource {
  const u64* bins;
  __device__ __forceinline__ u64 operator()(int i) const { return bins[i]; }
};

__device__ __forceinline__ int pow2_at_least(int n) {
  int m = 1;
  while (m < n) m <<= 1;
  return m;
}

// Ascending bitonic sort of buf[0, m), m a power of two; the caller
// synchronises before, the last stage after.
__device__ void bitonic_sort(u64* buf, int m) {
  for (int size = 2; size <= m; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (m >> 1); t += kThreads) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const u64 a = buf[i], b = buf[j];
        if ((a > b) == ((i & size) == 0)) {
          buf[i] = b;
          buf[j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Append every key of src[0, n) that is <= limit to buf (in no order; the
// first kCap of them stored) and return how many there are. *count is 0 on
// entry, set by the caller before a barrier.
template <class Src>
__device__ int collect(const Src& src, int n, u64 limit, u64* buf, int* count) {
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < n; base += kThreads * kUnroll) {
    u64 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      x[u] = i < n ? src(i) : kPad;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool keep = x[u] <= limit;
      const unsigned mask = __ballot_sync(0xffffffffu, keep);
      if (mask == 0) continue;
      int at = 0;
      if (lane == 0) at = atomicAdd(count, __popc(mask));
      at = __shfl_sync(0xffffffffu, at, 0) + __popc(mask & ((1u << lane) - 1u));
      if (keep && at < kCap) buf[at] = x[u];
    }
  }
  __syncthreads();
  const int c = *count;
  __syncthreads();
  return c;
}

// The k smallest keys of src[0, n) into d_out / i_out (a row of k), in
// ascending order; indices >= nk reported as nk - 1. buf holds kCap keys,
// hist 256 ints, scal 4 ints, all in shared memory.
template <class Src>
__device__ void select_k(const Src& src, int n, int k, int nk, u64* buf, int* hist, int* scal,
                         float* __restrict__ d_out, int* __restrict__ i_out) {
  const int tid = threadIdx.x;
  int m;
  if (n <= kCap) {
    m = pow2_at_least(n);
    for (int i = tid; i < m; i += kThreads) buf[i] = i < n ? src(i) : kPad;
    __syncthreads();
  } else {
    const int stride = (n + kSample - 1) / kSample;
    const int s = (n + stride - 1) / stride;
    for (int j = tid; j < kSample; j += kThreads) buf[j] = j < s ? src(j * stride) : kPad;
    __syncthreads();
    bitonic_sort(buf, kSample);
    const float mu = float(k) * float(s) / float(n);  // the k-th key's expected rank in the sample
    const int r = min(s, (int)ceilf(mu + 3.0f * sqrtf(mu) + 3.0f));
    const u64 limit = buf[r - 1];
    if (tid == 0) scal[0] = 0;
    __syncthreads();
    int c = collect(src, n, limit, buf, scal);
    if (c < k || c > kCap) {
      // Radix select: fix the k-th key 8 bits at a time from the top until
      // every key at or below the fixed bits fits the buffer.
      u64 prefix = 0;
      int shift = 64, rank = k, less = 0, eq = 0;
      do {
        shift -= 8;
        for (int b = tid; b < 256; b += kThreads) hist[b] = 0;
        __syncthreads();
        const u64 high = shift == 56 ? 0ull : ~0ull << (shift + 8);
        for (int i = tid; i < n; i += kThreads) {
          const u64 x = src(i);
          if ((x & high) == prefix) atomicAdd(&hist[unsigned(x >> shift) & 255u], 1);
        }
        __syncthreads();
        if (tid == 0) {
          int b = 0, below = 0;
          while (b < 255 && below + hist[b] < rank) below += hist[b++];
          scal[1] = b;
          scal[2] = below;
          scal[3] = hist[b];
        }
        __syncthreads();
        prefix |= u64(scal[1]) << shift;
        rank -= scal[2];
        less += scal[2];
        eq = scal[3];
        __syncthreads();
      } while (shift > 0 && less + eq > kCap);
      const u64 upper = prefix | (shift == 0 ? 0ull : (1ull << shift) - 1ull);
      if (tid == 0) scal[0] = 0;
      __syncthreads();
      c = collect(src, n, upper, buf, scal);
    }
    c = min(c, kCap);  // more only with equal keys, which the indices rule out
    m = pow2_at_least(c);
    for (int i = c + tid; i < m; i += kThreads) buf[i] = kPad;
    __syncthreads();
  }
  bitonic_sort(buf, m);
  for (int j = tid; j < k; j += kThreads) {
    const u64 x = buf[j];
    d_out[j] = __uint_as_float(unsigned(x >> 32));
    i_out[j] = min(int(unsigned(x)), nk - 1);
  }
}

// Block blockIdx.x = b * Nq + q. bins == 0: exact; else the strided bins.
__global__ void __launch_bounds__(kThreads)
knn_select_kernel(const float* __restrict__ query, const float* __restrict__ key,
                  const unsigned char* __restrict__ valid, int Nq, int Nk, int k, int bins,
                  float* __restrict__ d_out, int* __restrict__ i_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* buf = reinterpret_cast<u64*>(smem);
  u64* bin = buf + kCap;
  int* hist = reinterpret_cast<int*>(bin + bins);
  int* scal = hist + 256;
  const int row = blockIdx.x, b = row / Nq;
  const float qx = query[3 * (size_t)row], qy = query[3 * (size_t)row + 1],
              qz = query[3 * (size_t)row + 2];
  const KeySource src{qx, qy, qz, dot3(qx, qy, qz, qx, qy, qz), key + (size_t)b * Nk * 3,
                      valid == nullptr ? nullptr : valid + (size_t)b * Nk};
  float* d_row = d_out + (size_t)row * k;
  int* i_row = i_out + (size_t)row * k;
  if (bins == 0) {
    select_k(src, Nk, k, Nk, buf, hist, scal, d_row, i_row);
    return;
  }
  for (int j = threadIdx.x; j < bins; j += kThreads) {
    u64 m = kInfKey | unsigned(Nk + j);
#pragma unroll 4
    for (int i = j; i < Nk; i += bins) {
      const u64 x = src(i);
      m = x < m ? x : m;
    }
    bin[j] = m;
  }
  __syncthreads();
  select_k(BinSource{bin}, bins, k, Nk, buf, hist, scal, d_row, i_row);
}

}  // namespace

// query [B, Nq, 3] f32, key [B, Nk, 3] f32, valid [B, Nk] uint8 or NULL;
// k in [1, min(1024, Nk)]; bins 0 (exact) or in [k, 26624]; outputs d2
// [B, Nq, k] f32 and idx [B, Nq, k] int32.
extern "C" int psam_knn_select(const void* query, const void* key, const void* valid, int B,
                               int Nq, int Nk, int k, int bins, void* d_out, void* i_out,
                               void* stream) {
  if (B <= 0 || Nq <= 0 || Nk <= 0 || k < 1 || k > kMaxK || k > Nk || bins < 0 ||
      bins > kMaxBins || (bins > 0 && bins < k) || (long long)B * Nq > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      knn_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(kFixedSmem + kMaxBins * sizeof(u64)));
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem = kFixedSmem + (size_t)bins * sizeof(u64);
  knn_select_kernel<<<B * Nq, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const float*>(key),
      static_cast<const unsigned char*>(valid), Nq, Nk, k, bins, static_cast<float*>(d_out),
      static_cast<int*>(i_out));
  return (int)cudaGetLastError();
}
