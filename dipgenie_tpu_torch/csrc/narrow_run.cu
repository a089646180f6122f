// K1: one run of narrow pair-DP transitions.
//
// Replaces dipgenie_tpu/ops/diploid_pallas.py `_narrow_kernel` (launched by
// `_narrow_call`). The TPU kernel gathered with one-hot MXU matmuls over
// balanced s8 digit planes and took the per-destination max with a
// lane-roll segmented scan; here the gather is an indexed load and the
// max is a 64-bit atomicMax on an order-independent key (dg_common.cuh),
// which gives the same tie rule (earliest pair in plan order).
//
// What bounds it on the H100: the level chain is serial (each transition
// reads the state the previous one wrote) and a narrow transition has
// only ~0.3k-33k pairs x (R+1) rows of work, far too little to fill 132
// SMs. So the cost is latency: per transition two block barriers plus a
// few rounds of L1/L2 loads and L2 atomics, not bytes or FLOPs.
//
// Design: ONE block of 1024 threads walks every transition of the run,
// so a run is one launch (the TPU kernel's sequential grid becomes a
// loop inside the block). The state V [R+1, 1024] int32 is updated in
// place in global memory (L1/L2 resident): the candidate phase only reads
// V and max-reduces into keys [R+1, 1024]; after a barrier the commit
// phase swaps each key of the destination extent back to 0 and writes V
// and the int16 backpointer. R is a run-time argument with no upper
// limit (the TPU kernel padded to 24 or 32 rows); keys (8 KB a row) and V
// (4 KB a row) would fit a block's 227 KB of shared memory only up to
// R = 17, so they stay in global memory. Shared-memory state for small R,
// and several blocks per transition, are later work.
#include "dg_common.cuh"

namespace {

__global__ void __launch_bounds__(1024)
narrow_run_kernel(const int32_t* __restrict__ tbl,
                  const int32_t* __restrict__ sbits,
                  const int32_t* __restrict__ chunkbase,
                  const int32_t* __restrict__ tb_bits,
                  const int32_t* __restrict__ tb_bprow, int T, int nreal,
                  int R1, int32_t* V, dg::Key* keys, int16_t* bp256,
                  int16_t* bp1024) {
  using namespace dg;
  for (int t = 0; t < T; ++t) {
    const int c0 = chunkbase[t];
    const int c1 = (t + 1 < T) ? chunkbase[t + 1] : nreal;
    const int nl = (c1 - c0) * CHUNK;  // pair lanes, pads included
    const int out = CHUNK * (((sbits[c0] >> 7) & 3) + 1);

    // candidates: work item (r, p), p fastest so a warp reads one row
    for (int idx = threadIdx.x; idx < nl * R1; idx += blockDim.x) {
      const int r = idx / nl;
      const int p = idx - r * nl;
      const int* row0 = tbl + ((size_t)(c0 + p / CHUNK) * 2) * CHUNK;
      const int packed = row0[p % CHUNK];
      const int dst = ((packed >> 2) & 2047) - 1;  // -1 on padded lanes
      const int rs = r - (packed & 3);
      if (dst < 0 || rs < 0) continue;
      const int c = V[rs * 1024 + (packed >> 13)];
      if (c < REACH_T) continue;
      atomicMax(&keys[r * 1024 + dst], make_key(c + row0[CHUNK + p % CHUNK], p));
    }
    __syncthreads();

    // commit the destination extent [0, out); lanes past it keep stale
    // values that no later transition gathers
    const bool bp_wide = (tb_bits[t] & 2) != 0;
    const int ld = bp_wide ? 1024 : CHUNK;
    int16_t* bp = (bp_wide ? bp1024 : bp256) + (size_t)tb_bprow[t] * R1 * ld;
    for (int idx = threadIdx.x; idx < R1 * out; idx += blockDim.x) {
      const int r = idx / out;
      const int d = idx - r * out;
      const Key k = atomicExch(&keys[r * 1024 + d], 0ull);
      V[r * 1024 + d] = key_value(k);
      bp[r * ld + d] = (int16_t)key_ordinal(k);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int dg_narrow_run(const int32_t* tbl, const int32_t* sbits,
                             const int32_t* chunkbase, const int32_t* tb_bits,
                             const int32_t* tb_bprow, int T, int nreal, int R1,
                             int32_t* V, dg::Key* keys, int16_t* bp256,
                             int16_t* bp1024, cudaStream_t stream) {
  if (T > 0) {
    narrow_run_kernel<<<1, 1024, 0, stream>>>(tbl, sbits, chunkbase, tb_bits,
                                              tb_bprow, T, nreal, R1, V, keys,
                                              bp256, bp1024);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* dg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
