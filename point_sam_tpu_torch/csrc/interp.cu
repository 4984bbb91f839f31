// K10: 3-NN interpolation weights, N query points against G keys.
//
// Replaces point_sam_tpu/ops/interp_pallas.py::interp_weights_pallas
// (_interp_kernel): for every query, its 3 nearest keys (ascending squared
// distance; among equal distances the smallest key index first, as the
// Pallas kernel's three masked min/argmin extractions give) and the
// weights 1 / max(d^2, eps), normalised over the three.
//
// What bounds it on the H100: the N x G distance matrix (1 GiB in fp32 at
// N=131072, G=2048) would make it bandwidth-bound if it touched device
// memory; kept in registers, the instructions of a (query, key) pair bound
// it. The scan is nn3.cuh's, shared with K1's 3-NN launch: keys through
// shared memory as float4 in tiles, a query a thread, the keys taken a
// batch at a time into registers and scanned in order with strict <, so the
// indices equal the reference's (see nn3.cuh for the d^2 bits). The launch
// needs no function attribute: the key tile is static shared memory.
#include "common.cuh"
#include "nn3.cuh"

namespace {

constexpr int kMaxKeys = 16384;

}  // namespace

// query [B, N, 3] f32, key [B, G, 3] f32 (3 <= G <= 16384); outputs
// idx [B, N, 3] int32 and weight [B, N, 3] f32.
extern "C" int psam_interp_weights(const void* query, const void* key, int B, int N, int G,
                                   float eps, void* idx_out, void* w_out, void* stream) {
  if (B <= 0 || N <= 0 || G < 3 || G > kMaxKeys) return (int)cudaErrorInvalidValue;
  return psam::launch_nn3<true>(query, key, B, N, G, eps, idx_out, w_out, stream);
}
