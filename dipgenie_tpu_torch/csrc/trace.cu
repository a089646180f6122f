// K-T: the traceback, one sequential walk over every segment.
//
// Replaces dipgenie_tpu/ops/diploid_pallas.py `_narrow_trace` (a reverse
// lax.scan per segment over backpointers rematerialised by re-running
// the segment) and the per-segment dispatch around it. Here every
// segment's backpointers stay resident on the card, so one launch walks
// all L-1 transitions from the sink back to level 0.
//
// What bounds it on the H100: a chain of dependent loads (bp -> packed
// pair entry -> next bp row), ~4 L2/HBM latencies per transition, with
// no parallelism to exploit: the walk is inherently serial. Design: one
// thread; each transition's addresses come from a descriptor row built
// on the host (ops/trace.py), so narrow (int16 bp, `gidx << 13` packing),
// dense wide (int32 bp, `gidx << 17` packing) and window-split wide
// (int32 bp, one row per 1024-lane window, `gidx << 13` packing) segments
// share one loop. As in `_narrow_trace`, a lane of a 1024-class block is
// row `lane / lanes`, column `lane % lanes` from the block's row (a split
// run's lane `win * 1024 + rel` lies in its window's row); a 256-class
// block clamps the column.
#include "dg_common.cuh"

namespace {

// descriptor columns (ops/trace.py `_descriptors`)
enum { D_BP, D_LANES, D_ESIZE, D_TBL, D_W1, D_SY, D_DENSE, D_BIN, D_BOUT,
       D_ROWSTEP, D_ROWS, D_COLS };

__global__ void trace_kernel(const long long* __restrict__ desc, int T, int R,
                             int32_t* recs) {
  using namespace dg;
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  int lane = 0, r = R;
  for (int t = T - 1; t >= 0; --t) {
    const long long* d = desc + (size_t)t * D_COLS;
    const int lanes = (int)d[D_LANES];
    // clamped like the reference's dynamic_slice: only a walk from an
    // unreachable sink leaves [0, R] or the bp array
    int row = 0, col = lane < lanes ? lane : lanes - 1;
    if (d[D_ROWSTEP]) {
      row = lane / lanes;
      if (row > (int)d[D_ROWS] - 1) row = (int)d[D_ROWS] - 1;
      col = lane % lanes;
    }
    const size_t off = ((size_t)row * (R + 1) + (r < 0 ? 0 : r)) * lanes + col;
    const int slot = d[D_ESIZE] == 2
                         ? (int)((const int16_t*)d[D_BP])[off]
                         : ((const int32_t*)d[D_BP])[off];
    const int crow = slot / CHUNK;
    const int lc = slot % CHUNK;
    const int packed = ((const int32_t*)d[D_TBL])[(size_t)crow * 2 * CHUNK + lc];
    const int gidx = d[D_DENSE] ? ((packed >> 17) & 32767) : (packed >> 13);
    const int wsum = packed & 3;
    const int w1 = ((const int8_t*)d[D_W1])[(size_t)crow * CHUNK + lc];
    const int sy = ((const int16_t*)d[D_SY])[(size_t)crow * CHUNK + lc];
    const int bin = (int)d[D_BIN];
    const int bout = (int)d[D_BOUT];
    int32_t* o = recs + (size_t)t * 7;
    o[0] = gidx / bin;
    o[1] = gidx % bin;
    o[2] = lane / bout;
    o[3] = lane % bout;
    o[4] = w1;
    o[5] = wsum - w1;
    o[6] = sy;
    lane = gidx;
    r -= wsum;
  }
}

}  // namespace

extern "C" int dg_trace(const long long* desc, int T, int R, int32_t* recs,
                        cudaStream_t stream) {
  if (T > 0) trace_kernel<<<1, 32, 0, stream>>>(desc, T, R, recs);
  return (int)cudaGetLastError();
}
