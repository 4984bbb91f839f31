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
//   smallest key of each strided bin {i : i mod L == j}, then the k
//   smallest of the L bin minima (an empty bin, j >= Nk, holds (+inf,
//   Nk + j), after every real key, so it is never among them); an index
//   >= Nk is reported as Nk - 1.
//
// Layout (the launch plan, ops/knn.py::k12_plan, checked here against
// ``layout``). A block takes ``warps`` x QW queries of one batch row: QW (2
// or 4) a scoring warp, their coordinates in registers, 8 scoring warps where
// that still fills the 132 SMs (16 queries a block at the serve shape, 32 at
// hier4096's). Two more warps stage the row's keys, tile by tile (1024 keys),
// through a ring in shared memory: one thread asks the Tensor Memory
// Accelerator for the raw tile (a 1-D bulk copy of the fp32 triples and one
// of the valid bytes, from and to 16-byte boundaries, completing on the raw
// slot's LOADED mbarrier), and the two warps turn it into (x, y, z, k^2)
// float4s (k^2 once a key, with the FMAs above) and one word of valid bits
// for 32 keys in one of three staged slots (FULL mbarrier); an invalid or
// absent key is staged as (0, 0, 0, +inf). The first two copies are asked
// for before the sample is read, so they land meanwhile. A scoring warp
// waits on a slot's FULL, scores it and arrives on its EMPTY, so the warps
// drift apart and a key read from L2 serves the whole block.
//
// Selection, each query by the warp that holds it:
// - a bound: the block stages a strided sample of up to 4096 keys into the
//   (still empty) candidate buffers; each lane keeps the 8 smallest d^2 of
//   its share for each query, the warp sorts the 256 and takes the r-th (r
//   from the plan: the expected rank in the sample of the k-th key, or in
//   approximate mode of the key that fills the k-th bin, plus 4 sigma and
//   4); the bound is the key (that d^2, Nk - 1);
// - the scan: each lane takes 2 keys a step (one 16-byte shared load each)
//   against its warp's QW queries, the fp32 sum (q2 - 2 dot) + k2 against
//   the bound's d^2 (6 fp32 operations and a compare a pair), and sets one
//   bit a (query, key) where it is not above (a NaN sum too). No vote in
//   the scan, so its steps overlap;
// - the hits: the 64-bit key of each hit (its d^2 through a select on the
//   staged valid flag, so an invalid key is +inf whatever its coordinates;
//   the staged zeros only keep the compare from passing it), appended to
//   the query's buffer (``cap`` keys in shared memory) where at or below
//   the bound: each lane its own hits, two at a time, through a shared
//   counter, where the tile's hits fit; else a position at a time by ballot;
// - a buffer that would overflow is sorted and cut to its k smallest
//   (approximate mode: first to one key a bin), and its k-th key becomes
//   the bound, so the bound only tightens and no key below it is lost;
// - at the end the warp sorts the buffer (bitonic: in registers, with
//   shuffles for the cross-lane stages, up to 1024 keys; through shared
//   memory at 2048), in approximate mode keeps the first key of each bin (a
//   bitmap of the bins; __match_any_sync within 32 keys), and writes the
//   first k;
// - where the sample misjudged (fewer than k keys, or k bins, at or below
//   its bound) the block scans the keys again for those queries with every
//   key a candidate: rare, exact, and read through L2 once more.
//
// What bounds it on the H100: the operations, about 8 fp32 a (query, key)
// pair (0.032 ms for 2048 x 131072 at 67 TFLOP/s); the block reads 13 bytes
// a key from L2 once a walk (1.7 MB at 131072 keys, not the 3.5 GB of one
// block a query) and writes k keys a query. On top come the sample (~8% of
// the time at the serve shape), the appends of the ~3k keys below a bound
// (the bound is loose by that much at a 4096-key sample) and the sorts of
// up to 1024 64-bit keys (integer compares and selects, ~15%).
#include "common.cuh"
#include "mma.cuh"

namespace {

using u64 = unsigned long long;
using psam::smem_u32;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kU = 2;         // keys a lane scores a step
constexpr int kConv = 4;      // keys a staging lane converts at once
constexpr int kStagers = 2;   // staging warps a block
constexpr int kSlots = 3;     // staged tiles in the ring (raw tiles: 2)
constexpr int kTop = 8;       // sample distances a lane keeps for each query
constexpr int kMaxK = 1024;
constexpr int kMaxBins = 26624;
constexpr int kMaxCap = 2048;
constexpr int kMaxSmem = 232448;  // the shared memory an H100 block may opt into
constexpr u64 kPad = ~0ull;       // above every key: pads a sort

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Byte offsets of the shared-memory regions; ops/knn.py::k12_smem_bytes
// computes the same total.
struct Layout {
  size_t buf, conv, vbits, raw, vraw, bmap, flag, bars, total;
};

__host__ __device__ inline Layout layout(int warps, int qw, int cap, int tile, int sample,
                                         int bins) {
  Layout l{};
  const size_t cand = (size_t)warps * qw * cap * 8, samp = (size_t)sample * 17;
  size_t o = 0;
  l.buf = o;    // the candidate buffers; the sample's staging before they fill
  o += align16(cand > samp ? cand : samp);
  l.conv = o;   // kSlots tiles of (x, y, z, k^2)
  o += kSlots * (size_t)tile * 16;
  l.vbits = o;  // their valid bits
  o += align16(kSlots * (size_t)(tile / 32) * 4);
  l.raw = o;    // two raw tiles (fp32 triples; 16 bytes for the misalignment)
  o += 2 * align16((size_t)tile * 12 + 16);
  l.vraw = o;   // their valid bytes
  o += 2 * align16((size_t)tile + 16);
  l.bmap = o;   // approximate mode: a bitmap of the bins for each warp
  o += align16((size_t)warps * ((bins + 31) / 32) * 4);
  l.flag = o;   // "some query of the block scans again", then each query's count
  o += align16(4 + (size_t)warps * qw * 4);
  l.bars = o;   // the ring's mbarriers: LOADED of each raw slot, FULL and EMPTY of each staged one
  o += 8 * (2 + 2 * kSlots);
  l.total = o;
  return l;
}

// The ring's mbarriers: LOADED of a slot completes when a tile's bytes have
// landed in its raw slot, FULL when the staging warps have staged it (one
// arrival a warp), EMPTY when every scoring warp has scored it (one arrival
// a warp); a warp waits on the parity of the use. The staging warps also
// meet at named barrier 1.
__device__ __forceinline__ void stagers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(32 * kStagers) : "memory");
}

__device__ __forceinline__ void mbar_init(u64* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(u64* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(u64* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Expect ``bytes`` more on ``bar`` and arrive; a bulk copy of ``bytes``
// global -> shared (both 16-byte aligned, a multiple of 16) that completes
// them on ``bar`` (the Tensor Memory Accelerator's 1-D copy).
__device__ __forceinline__ void mbar_expect(u64* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes, u64* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  return __fmaf_rn(az, bz, __fmaf_rn(ay, by, __fmul_rn(ax, bx)));
}

// (q2 - 2 dot) + k2 for a staged key (x, y, z, k2).
__device__ __forceinline__ float dist_sum(float qx, float qy, float qz, float q2,
                                          const float4& k) {
  return __fadd_rn(__fsub_rn(q2, __fmul_rn(2.0f, dot3(qx, qy, qz, k.x, k.y, k.z))), k.w);
}

// -0 and NaN become +0, as the plain version's where(d2 > 0, d2, 0).
__device__ __forceinline__ float clamp0(float s) { return s > 0.0f ? s : 0.0f; }

__device__ __forceinline__ u64 pack(float d2, unsigned index) {
  return (u64(__float_as_uint(d2)) << 32) | index;
}

// ---- sorting: bitonic, one warp ----

template <class V>
__device__ __forceinline__ void cas(V& a, V& b, bool up) {
  const bool swap = (b < a) == up;
  const V lo = swap ? b : a;
  b = swap ? a : b;
  a = lo;
}

// The stages from (SIZE, STRIDE) on of an ascending bitonic sort of the
// 32 * E values x, lane-major (element lane * E + j is x[j] of that lane).
template <int E, int SIZE, int STRIDE, class V>
__device__ __forceinline__ void bitonic(V (&x)[E], int lane) {
  if constexpr (STRIDE >= E) {  // partners in another lane
    const bool lower = (lane & (STRIDE / E)) == 0;
    const bool up = (lane & (SIZE / E)) == 0;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const V y = __shfl_xor_sync(kFull, x[j], STRIDE / E);
      x[j] = ((y < x[j]) == (lower == up)) ? y : x[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j)
      if ((j & STRIDE) == 0) cas(x[j], x[j + STRIDE], SIZE < E ? (j & SIZE) == 0
                                                                 : (lane & (SIZE / E)) == 0);
  }
  if constexpr (STRIDE > 1)
    bitonic<E, SIZE, STRIDE / 2>(x, lane);
  else if constexpr (SIZE < 32 * E)
    bitonic<E, SIZE * 2, SIZE>(x, lane);
}

// Element e of a lane-major sorted x, in every lane.
template <int E, class V>
__device__ __forceinline__ V pick(const V (&x)[E], int e, int lane) {
  V v = x[0];
#pragma unroll
  for (int j = 1; j < E; ++j)
    if (j == e % E) v = x[j];
  return __shfl_sync(kFull, v, e / E);
}

template <int E>
__device__ __forceinline__ void sort_in_registers(u64* buf, int lane) {
  u64 x[E];
#pragma unroll
  for (int j = 0; j < E; ++j) x[j] = buf[j * 32 + lane];  // any order: conflict-free
  bitonic<E, 2, 1>(x, lane);
#pragma unroll
  for (int j = 0; j < E; ++j) buf[lane * E + j] = x[j];
}

// Ascending sort of buf[0, m), m a power of two in [32, kMaxCap].
__device__ __noinline__ void warp_sort(u64* buf, int m) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  switch (m) {
    case 32: sort_in_registers<1>(buf, lane); break;
    case 64: sort_in_registers<2>(buf, lane); break;
    case 128: sort_in_registers<4>(buf, lane); break;
    case 256: sort_in_registers<8>(buf, lane); break;
    case 512: sort_in_registers<16>(buf, lane); break;
    case 1024: sort_in_registers<32>(buf, lane); break;
    default:  // 2048 (k > 448): through shared memory
      for (int size = 2; size <= m; size <<= 1)
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
          for (int t = lane; t < (m >> 1); t += 32) {
            const int i = 2 * t - (t & (stride - 1)), j = i + stride;
            u64 a = buf[i], b = buf[j];
            cas(a, b, (i & size) == 0);
            buf[i] = a;
            buf[j] = b;
          }
          __syncwarp();
        }
  }
  __syncwarp();
}

// Sort the cnt keys of buf (padded to a power of two); in approximate mode
// (bins > 0) then keep, in order, the first (smallest) key of each bin,
// stopping once ``need`` are kept. Returns the keys kept.
__device__ __noinline__ int settle(u64* buf, int cnt, int need, int bins, unsigned* bmap) {
  const int lane = threadIdx.x & 31;
  int m = 32;
  while (m < cnt) m <<= 1;
  for (int e = cnt + lane; e < m; e += 32) buf[e] = kPad;
  warp_sort(buf, m);
  if (bins == 0) return cnt;
  for (int w = lane; w < (bins + 31) / 32; w += 32) bmap[w] = 0u;
  __syncwarp();
  int kept = 0;
  for (int c0 = 0; c0 < cnt && kept < need; c0 += 32) {
    const int e = c0 + lane;
    const bool has = e < cnt;
    const u64 x = has ? buf[e] : 0ull;
    const unsigned bin = has ? unsigned(x) % unsigned(bins) : unsigned(bins + lane);
    const unsigned peers = __match_any_sync(kFull, bin);  // sorted: the lowest lane is first
    const bool fresh = has && __ffs(peers) - 1 == lane &&
                       ((bmap[bin >> 5] >> (bin & 31)) & 1u) == 0u;
    __syncwarp();
    if (fresh) atomicOr(bmap + (bin >> 5), 1u << (bin & 31));
    const unsigned mask = __ballot_sync(kFull, fresh);
    if (fresh) buf[kept + __popc(mask & ((1u << lane) - 1u))] = x;  // at or before e
    kept += __popc(mask);
    __syncwarp();
  }
  return kept;
}

// The tile ring in shared memory: two raw slots (fp32 triples, valid
// bytes) and kSlots staged slots ((x, y, z, k^2), valid bits); and where the
// batch row's keys start: its bytes are copied from the 16-byte boundary at
// or before it (the tensors' bases are 16-byte aligned and their sizes
// rounded up to 16 bytes, and a tile is 12 KB, so every tile starts
// ``kmis`` bytes past a boundary).
struct Ring {
  unsigned char* raw;
  unsigned char* vraw;
  float4* conv;
  unsigned* vbits;
  const char* kbase;           // the boundary at or before the row's keys
  const unsigned char* vbase;  // and its valid bytes (nullptr: all valid)
  int kmis, vmis;              // the row's offset past them
  int n;                       // keys in the row
};

constexpr int kTile = 1024;  // keys a tile
static_assert(kTile % (kConv * 32 * kStagers) == 0, "the staging threads split a tile evenly");
constexpr int kRawBytes = kTile * 12 + 16, kValidBytes = kTile + 16;

// Tile t's raw keys and valid bytes into raw slot ``slot``: one bulk copy
// each, from and to 16-byte boundaries, completing on ``bar``; by one thread.
__device__ __forceinline__ void stage(const Ring& r, int t, int slot, u64* bar) {
  if (t * kTile >= r.n) return;
  const int n = min(kTile, r.n - t * kTile);
  const int from = (r.kmis + t * kTile * 12) & ~15, bytes = (r.kmis + 12 * n + 15) & ~15;
  const int vfrom = (r.vmis + t * kTile) & ~15, vbytes = r.vbase ? (r.vmis + n + 15) & ~15 : 0;
  mbar_expect(bar, bytes + vbytes);
  bulk_copy(r.raw + slot * kRawBytes, r.kbase + from, bytes, bar);
  if (vbytes) bulk_copy(r.vraw + slot * kValidBytes, r.vbase + vfrom, vbytes, bar);
}

// Tile t's raw slot ``rslot`` into staged slot ``slot``: (x, y, z, k^2), or (0, 0, 0,
// +inf) for an invalid or absent key, and a word of valid bits for 32
// keys; by the staging warps (thread ``lane`` of 32 * kStagers), kConv
// keys a thread at once, all read before any is written.
__device__ __forceinline__ void convert(const Ring& r, int t, int rslot, int slot, int lane) {
  if (t * kTile >= r.n) return;
  const int n = min(kTile, r.n - t * kTile);
  const float* xyz = reinterpret_cast<const float*>(r.raw + rslot * kRawBytes + r.kmis);
  const unsigned char* vr = r.vraw + rslot * kValidBytes + r.vmis;
  float4* cv = r.conv + slot * kTile;
  unsigned* vw = r.vbits + slot * (kTile / 32);
#pragma unroll 1
  for (int e0 = lane; e0 < kTile; e0 += kConv * 32 * kStagers) {
    float x[kConv], y[kConv], z[kConv];
    bool v[kConv];
#pragma unroll
    for (int i = 0; i < kConv; ++i) {
      const int e = e0 + 32 * kStagers * i;
      v[i] = e < n && (r.vbase == nullptr || vr[e] != 0);
      x[i] = xyz[3 * e];
      y[i] = xyz[3 * e + 1];
      z[i] = xyz[3 * e + 2];
    }
#pragma unroll
    for (int i = 0; i < kConv; ++i) {
      const int e = e0 + 32 * kStagers * i;
      cv[e] = v[i] ? make_float4(x[i], y[i], z[i], dot3(x[i], y[i], z[i], x[i], y[i], z[i]))
                   : make_float4(0.0f, 0.0f, 0.0f, INFINITY);
      const unsigned bits = __ballot_sync(kFull, v[i]);
      if ((lane & 31) == 0) vw[e >> 5] = bits;
    }
  }
}

// Block blockIdx.x = b * groups + g takes queries [g * QW * warps, ...) of
// batch row b; warp w holds QW of them. bins == 0: exact; else the strided
// bins. sample == 0: no sample, every key a candidate from the start.
template <int QW>
__global__ void __launch_bounds__(256 + 32 * kStagers, 1)
knn_select_kernel(const float* __restrict__ query, const float* __restrict__ key,
                  const unsigned char* __restrict__ valid, int B, int Nq, int Nk, int k, int bins,
                  int cap, int tile, int sample, int stride, int rank, float* __restrict__ d_out,
                  int* __restrict__ i_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  // Warps 0 .. warps - 1 score, the last kStagers warps stage the tiles.
  const int warps = (blockDim.x >> 5) - kStagers, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool stager = warp >= warps;
  const int slane = threadIdx.x - 32 * warps;  // a staging thread's index
  const Layout lay = layout(warps, QW, cap, tile, sample, bins);
  const int qpb = warps * QW, groups = (Nq + qpb - 1) / qpb;
  const int b = blockIdx.x / groups;
  const int qbase = (blockIdx.x - b * groups) * qpb + warp * QW;
  u64* const wbuf = reinterpret_cast<u64*>(smem + lay.buf) + (size_t)warp * QW * cap;
  unsigned* const bmap = reinterpret_cast<unsigned*>(smem + lay.bmap) + warp * ((bins + 31) / 32);
  volatile int* const again = reinterpret_cast<int*>(smem + lay.flag);
  int* const wcnt = reinterpret_cast<int*>(smem + lay.flag) + 1 + warp * QW;
  const u64 every = pack(INFINITY, unsigned(Nk - 1));  // every real key, no absent one
  u64* const loaded = reinterpret_cast<u64*>(smem + lay.bars);
  u64* const full = loaded + 2;
  u64* const empty = full + kSlots;
  if (threadIdx.x == 0) {
    *again = 0;
    mbar_init(loaded, 1);
    mbar_init(loaded + 1, 1);
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(full + s, kStagers);
      mbar_init(empty + s, warps);
    }
  }
  __syncthreads();
  const int ntiles = (Nk + kTile - 1) / kTile;
  const size_t koff = (size_t)b * Nk * 12, voff = (size_t)b * Nk;
  const Ring ring{smem + lay.raw, smem + lay.vraw, reinterpret_cast<float4*>(smem + lay.conv),
                  reinterpret_cast<unsigned*>(smem + lay.vbits),
                  reinterpret_cast<const char*>(key) + (koff & ~size_t(15)),
                  valid == nullptr ? nullptr : valid + (voff & ~size_t(15)), int(koff & 15),
                  int(voff & 15), Nk};
  if (stager && slane == 0) {  // the first two tiles land while the sample is read
    stage(ring, 0, 0, loaded);
    stage(ring, 1, 1, loaded + 1);
  }

  float qx[QW], qy[QW], qz[QW], q2[QW], dB[QW];
  u64 T[QW];
  int cnt[QW];
  bool act[QW];
#pragma unroll
  for (int j = 0; j < QW; ++j) {
    act[j] = !stager && qbase + j < Nq;
    const float* p = query + ((size_t)b * Nq + (act[j] ? qbase + j : 0)) * 3;
    qx[j] = act[j] ? p[0] : 0.0f;
    qy[j] = act[j] ? p[1] : 0.0f;
    qz[j] = act[j] ? p[2] : 0.0f;
    q2[j] = dot3(qx[j], qy[j], qz[j], qx[j], qy[j], qz[j]);
    T[j] = every;
    cnt[j] = 0;
  }

  // The bound from the strided sample.
  if (sample > 0) {
    float4* const samp = reinterpret_cast<float4*>(smem + lay.buf);
    unsigned char* const sval = reinterpret_cast<unsigned char*>(samp + sample);
    for (int j = threadIdx.x; j < sample; j += blockDim.x) {
      const size_t i = (size_t)b * Nk + (size_t)j * stride;
      const float x = __ldg(key + 3 * i), y = __ldg(key + 3 * i + 1), z = __ldg(key + 3 * i + 2);
      samp[j] = make_float4(x, y, z, dot3(x, y, z, x, y, z));
      sval[j] = valid == nullptr ? 1 : __ldg(valid + i);
    }
    __syncthreads();
    float top[QW][kTop];  // (the staging warps hold no query and skip this)
#pragma unroll
    for (int j = 0; j < QW; ++j)
#pragma unroll
      for (int a = 0; a < kTop; ++a) top[j][a] = INFINITY;
    for (int t = lane; t < sample && !stager; t += 32) {
      const float4 kv = samp[t];
      const bool v = sval[t] != 0;
#pragma unroll
      for (int j = 0; j < QW; ++j) {
        float d = v ? clamp0(dist_sum(qx[j], qy[j], qz[j], q2[j], kv)) : INFINITY;
#pragma unroll
        for (int a = 0; a < kTop; ++a) {  // insert into the lane's sorted 8
          const float lo = fminf(top[j][a], d);
          d = fmaxf(top[j][a], d);
          top[j][a] = lo;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < QW; ++j) {
      bitonic<kTop, 2, 1>(top[j], lane);
      T[j] = pack(pick(top[j], rank - 1, lane), unsigned(Nk - 1));
    }
    __syncthreads();  // the sample is read before the buffers fill
  }
#pragma unroll
  for (int j = 0; j < QW; ++j) dB[j] = act[j] ? __uint_as_float(unsigned(T[j] >> 32)) : -INFINITY;


  for (int pass = 0;; ++pass) {
    bool live = false;
#pragma unroll
    for (int j = 0; j < QW; ++j) live |= act[j];
    // Tile t of the pass is the g-th tile the ring has held: raw slot g & 1
    // (its (g >> 1)-th use), staged slot g % kSlots (its (g / kSlots)-th).
    const int g0 = pass * ntiles;
    if (stager) {  // copy tile t + 2 and stage tile t while the warps score
      if (pass > 0 && slane == 0) {
        stage(ring, 0, g0 & 1, loaded + (g0 & 1));
        stage(ring, 1, (g0 + 1) & 1, loaded + ((g0 + 1) & 1));
      }
      for (int t = 0; t < ntiles; ++t) {
        const int g = g0 + t, slot = g % kSlots;
        mbar_wait(loaded + (g & 1), (g >> 1) & 1);  // tile g landed
        if (g >= kSlots) mbar_wait(empty + slot, (g / kSlots - 1) & 1);  // tile g - kSlots scored
        convert(ring, t, g & 1, slot, slane);
        __syncwarp();
        if (lane == 0) mbar_arrive(full + slot);
        stagers_sync();  // every staging thread has read the raw slot
        if (slane == 0) stage(ring, t + 2, g & 1, loaded + (g & 1));
      }
    }
    for (int t = 0; t < ntiles && !stager; ++t) {
      const int g = g0 + t, slot = g % kSlots;
      mbar_wait(full + slot, (g / kSlots) & 1);
      if (!live) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + slot);
        continue;
      }
      const int t0 = t * kTile;
      const float4* cv = ring.conv + slot * kTile;
      const unsigned* vw = ring.vbits + slot * (kTile / 32);
      // The scan: kU keys a lane a step against the warp's QW queries, one
      // bit a (query, key) in hits[j] where the fp32 sum is not above the
      // query's bound (a NaN sum too); no vote, so the steps overlap.
      unsigned hits[QW];
#pragma unroll
      for (int j = 0; j < QW; ++j) hits[j] = 0u;
#pragma unroll
      for (int step = 0; step < kTile / (32 * kU); ++step)
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const float4 kv = cv[step * 32 * kU + 32 * u + lane];
#pragma unroll
          for (int j = 0; j < QW; ++j)
            if (!(dist_sum(qx[j], qy[j], qz[j], q2[j], kv) > dB[j])) hits[j] |= 1u << (step * kU + u);
        }
      // Then the hits: each key's 64-bit key (the d^2 through a select on
      // the staged valid flag), appended where at or below the bound. Where
      // a pair of queries' hits fit their buffers (after cutting a buffer to
      // its k smallest if need be), each lane appends its own through one
      // shared counter a query; else (every key a candidate) a position at a
      // time by ballot, cutting the buffer whenever it fills. A cut tightens
      // the bound; a key above the new bound is above the old one, so a miss
      // hides no candidate.
      // A bound at +inf (fewer than k finite keys under it) passes every
      // invalid key; past the bound's index none of them can be kept, so
      // only the valid keys' hits stay.
      bool inf_bound = false;
#pragma unroll
      for (int j = 0; j < QW; ++j)
        inf_bound |= dB[j] == INFINITY && unsigned(T[j]) < unsigned(t0);
      if (inf_bound) {
        unsigned vm = 0u;
#pragma unroll
        for (int bit = 0; bit < kTile / 32; ++bit)
          vm |= ((vw[bit] >> lane) & 1u) << bit;  // hit bit = valid word of its key
#pragma unroll
        for (int j = 0; j < QW; ++j)
          if (dB[j] == INFINITY && unsigned(T[j]) < unsigned(t0)) hits[j] &= vm;
      }
#pragma unroll
      for (int j0 = 0; j0 < QW; j0 += 2) {  // the queries in pairs (QW is even)
        const unsigned both = __reduce_add_sync(kFull, __popc(hits[j0]) | __popc(hits[j0 + 1]) << 16);
        if (both == 0u) continue;
        bool fit = true;
#pragma unroll
        for (int j = j0; j < j0 + 2; ++j) {
          const int total = j == j0 ? int(both & 0xffffu) : int(both >> 16);
          if (cnt[j] + total > cap && cnt[j] > k) {
            u64* const qb = wbuf + j * cap;
            const int kept = settle(qb, cnt[j], k, bins, bmap);
            cnt[j] = min(kept, k);
            if (kept >= k) {
              T[j] = qb[k - 1];
              dB[j] = __uint_as_float(unsigned(T[j] >> 32));
            }
          }
          fit = fit && cnt[j] + total <= cap;
        }
        if (fit) {  // each lane appends its own hits of both queries
          if (lane == 0) {
            wcnt[j0] = cnt[j0];
            wcnt[j0 + 1] = cnt[j0 + 1];
          }
          __syncwarp();
          // Two hits a round, so that their loads and sums overlap.
          for (u64 mine = hits[j0] | u64(hits[j0 + 1]) << 32; mine != 0ull;) {
            int bits[2];
            bool has[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              has[h] = mine != 0ull;
              bits[h] = has[h] ? __ffsll(mine) - 1 : 0;
              mine &= mine - 1ull;
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int pos = bits[h] & 31;
              const bool second = bits[h] >= 32;
              const int j = second ? j0 + 1 : j0;
              const int e = (pos / kU) * 32 * kU + (pos % kU) * 32 + lane;
              const float sum = dist_sum(second ? qx[j0 + 1] : qx[j0], second ? qy[j0 + 1] : qy[j0],
                                         second ? qz[j0 + 1] : qz[j0],
                                         second ? q2[j0 + 1] : q2[j0], cv[e]);
              const bool v = (vw[e >> 5] >> lane) & 1u;
              const u64 kk = pack(v ? clamp0(sum) : INFINITY, unsigned(t0 + e));
              if (has[h] && (second ? act[j0 + 1] : act[j0]) && kk <= (second ? T[j0 + 1] : T[j0]))
                wbuf[j * cap + atomicAdd(wcnt + j, 1)] = kk;
            }
          }
          __syncwarp();
          cnt[j0] = wcnt[j0];
          cnt[j0 + 1] = wcnt[j0 + 1];
          continue;
        }
#pragma unroll
        for (int j = j0; j < j0 + 2; ++j) {
          u64* const qb = wbuf + j * cap;
          for (unsigned left = __reduce_or_sync(kFull, hits[j]); left != 0u; left &= left - 1u) {
            const int pos = __ffs(left) - 1;
            const int e = (pos / kU) * 32 * kU + (pos % kU) * 32 + lane;
            const float sum = dist_sum(qx[j], qy[j], qz[j], q2[j], cv[e]);
            const bool v = (vw[e >> 5] >> lane) & 1u;
            const u64 kk = pack(v ? clamp0(sum) : INFINITY, unsigned(t0 + e));
            bool keep = act[j] && kk <= T[j];
            unsigned m = __ballot_sync(kFull, keep);
            if (m == 0u) continue;
            if (cnt[j] + __popc(m) > cap) {
              const int kept = settle(qb, cnt[j], k, bins, bmap);
              cnt[j] = min(kept, k);
              if (kept >= k) {
                T[j] = qb[k - 1];
                dB[j] = __uint_as_float(unsigned(T[j] >> 32));
              }
              keep = keep && kk <= T[j];
              m = __ballot_sync(kFull, keep);
            }
            if (keep) qb[cnt[j] + __popc(m & ((1u << lane) - 1u))] = kk;
            cnt[j] += __popc(m);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);
    }

    bool missed = false;
#pragma unroll
    for (int j = 0; j < QW; ++j) {
      if (!act[j]) continue;
      u64* const qb = wbuf + j * cap;
      const int kept = bins == 0 && cnt[j] < k ? 0 : settle(qb, cnt[j], k, bins, bmap);
      if (kept >= k) {
        const size_t row = ((size_t)b * Nq + qbase + j) * k;
        for (int e = lane; e < k; e += 32) {
          const u64 x = qb[e];
          d_out[row + e] = __uint_as_float(unsigned(x >> 32));
          i_out[row + e] = min(int(unsigned(x)), Nk - 1);
        }
        act[j] = false;
        dB[j] = -INFINITY;
      } else {  // the sample misjudged: every key a candidate
        missed = true;
        T[j] = every;
        dB[j] = INFINITY;
        cnt[j] = 0;
      }
    }
    if (pass == 1) break;  // the second pass takes every key: always k
    if (missed && lane == 0) *again = 1;
    __syncthreads();
    if (*again == 0) break;
  }
}

}  // namespace

// query [B, Nq, 3] f32, key [B, Nk, 3] f32, valid [B, Nk] uint8 or NULL
// (key and valid 16-byte aligned); k in [1, min(1024, Nk)]; bins 0 (exact)
// or in [k, 26624]; the launch plan of ops/knn.py::k12_plan (warps, queries
// a warp, cap, tile, sample, stride, rank, smem, grid), checked against the
// layout here; outputs d2 [B, Nq, k] f32 and idx [B, Nq, k] int32.
extern "C" int psam_knn_select(const void* query, const void* key, const void* valid, int B,
                               int Nq, int Nk, int k, int bins, int warps, int qw, int cap,
                               int tile, int sample, int stride, int rank, int smem, int grid,
                               void* d_out, void* i_out, void* stream) {
  const bool args_ok =
      B > 0 && Nq > 0 && Nk > 0 && k >= 1 && k <= kMaxK && k <= Nk && bins >= 0 &&
      bins <= kMaxBins && (bins == 0 || bins >= k) &&
      (warps == 1 || warps == 2 || warps == 4 || warps == 8) && (qw == 2 || qw == 4) &&
      cap >= 32 && cap <= kMaxCap && (cap & (cap - 1)) == 0 && cap >= k &&
      (Nk <= cap || cap >= k + 32) && tile == kTile && (long long)B * Nk * 12 < 0x7fffffffLL &&
      (sample == 0 ? stride == 0 && rank == 0
                   : stride >= 1 && (long long)(sample - 1) * stride < Nk &&
                         (long long)sample * stride >= Nk && rank >= 1 && rank <= 32 * kTop) &&
      reinterpret_cast<uintptr_t>(key) % 16 == 0 && reinterpret_cast<uintptr_t>(valid) % 16 == 0;
  if (!args_ok) return (int)cudaErrorInvalidValue;
  const long long groups = (Nq + (long long)qw * warps - 1) / ((long long)qw * warps);
  const Layout lay = layout(warps, qw, cap, tile, sample, bins);
  if (lay.total != (size_t)smem || smem > kMaxSmem || (long long)grid != B * groups ||
      B * groups > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr2 = cudaFuncSetAttribute(
      knn_select_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  static const cudaError_t attr4 = cudaFuncSetAttribute(
      knn_select_kernel<4>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  const cudaError_t attr = qw == 4 ? attr4 : attr2;
  if (attr != cudaSuccess) return (int)attr;
  const auto kernel = qw == 4 ? knn_select_kernel<4> : knn_select_kernel<2>;
  kernel<<<grid, 32 * (warps + kStagers), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const float*>(key),
      static_cast<const unsigned char*>(valid), B, Nq, Nk, k, bins, cap, tile, sample, stride,
      rank, static_cast<float*>(d_out), static_cast<int*>(i_out));
  return (int)cudaGetLastError();
}
