// K15 chunk_step and K16 chunk_trace: the chunked DP tier.
//
// K15 replaces dipgenie_tpu/ops/diploid_jax.py `_step_body` (:177-272),
// run by `_scan_fn` (:440-464, lax.scan chunks of up to 512 small
// transitions padded with no-op steps) and `_big_fn` (:466-484, one
// transition padded to a (B, P, W) bucket): per transition, a thread a
// state (r, i2, j2) takes the max of vertex_dp.cuh and carries SH, the
// winner's source SH plus its popcount((Tl | Tl) ^ (Tr | Tr)) (0 where
// unreachable). On the traceback's replay it also writes the packed
// backpointer pi | pj << 12 | wu << 24 | wv << 25 (0 where unreachable) at
// the transition's element offset in the span's buffer. The host entry
// launches one kernel a transition, V and SH alternating between two
// global buffers each; no padding, no no-op steps.
//
// K16 replaces `_trace_fn` (:543-567): one thread walks a replayed span's
// packed words in reverse from the carry (i2, j2, r) in device memory and
// leaves the carry for the span before it.
//
// What bounds them on the H100: as K13 (fused_dp.cu), plus SH's gather and
// store (4 B each a state) and, on replay, the packed word (4 B a state).
// A simple design that is right first: a later PR makes them fast.
#include "vertex_dp.cuh"

namespace {

using namespace dgv;

__global__ void __launch_bounds__(THREADS)
chunk_step_kernel(Tables t, const int32_t* __restrict__ vin,
                  const int32_t* __restrict__ shin, int32_t* __restrict__ vout,
                  int32_t* __restrict__ shout, int32_t* __restrict__ bp,
                  int R1) {
  const long long n = (long long)R1 * t.k2 * t.k2;
  for (long long x = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       x < n; x += (long long)gridDim.x * blockDim.x) {
    int r, i2, j2;
    state_of(x, t.k2, r, i2, j2);
    const Win o = best_of(t, vin, r, i2, j2);
    const bool ok = o.v != NEG;
    vout[x] = o.v;
    shout[x] = ok ? __ldg(shin + o.src) + o.symd : 0;
    if (bp != nullptr)
      bp[x] = ok ? (o.a | o.b << 12 | o.wu << 24 | o.wv << 25) : 0;
  }
}

__global__ void chunk_trace_kernel(const long long* __restrict__ tdesc, int n,
                                   const int32_t* __restrict__ bp,
                                   int32_t* __restrict__ carry,
                                   int32_t* __restrict__ rows) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  int i2 = carry[0], j2 = carry[1], r = carry[2];
  for (int i = n - 1; i >= 0; --i) {
    const long long k2 = tdesc[2 * i];
    const int word = bp[tdesc[2 * i + 1] + ((long long)r * k2 + i2) * k2 + j2];
    const int a = word & 0xFFF, b = (word >> 12) & 0xFFF;
    const int wu = (word >> 24) & 1, wv = (word >> 25) & 1;
    int32_t* row = rows + 4LL * i;
    row[0] = a;
    row[1] = b;
    row[2] = wu;
    row[3] = wv;
    i2 = a;
    j2 = b;
    r = r - wu - wv > 0 ? r - wu - wv : 0;
  }
  carry[0] = i2;
  carry[1] = j2;
  carry[2] = r;
}

}  // namespace

// Transitions t0 .. t1 - 1, one launch each: (V, SH) of transition t0 in
// (va, sa), after transition t0 + i in (i even ? (vb, sb) : (va, sa)).
// desc is the host descriptor table; with bp, bp_off (host, t1 - t0
// int64) gives each transition's element offset in bp.
extern "C" int dg_chunk_forward(const long long* desc, int t0, int t1, int R1,
                                const int32_t* pred, const int32_t* deg,
                                const uint32_t* masks, int32_t* va,
                                int32_t* vb, int32_t* sa, int32_t* sb,
                                int32_t* bp, const long long* bp_off,
                                cudaStream_t stream) {
  if (R1 < 1 || t0 < 0 || t1 < t0 || (bp != nullptr && bp_off == nullptr))
    return (int)cudaErrorInvalidValue;
  int32_t* vbuf[2] = {va, vb};
  int32_t* sbuf[2] = {sa, sb};
  for (int t = t0; t < t1; ++t) {
    const Tables tb =
        tables_of(desc + (long long)t * DESC_COLS, pred, deg, masks);
    const int i = (t - t0) & 1;
    int32_t* words = bp != nullptr ? bp + bp_off[t - t0] : nullptr;
    chunk_step_kernel<<<grid_of((long long)R1 * tb.k2 * tb.k2), THREADS, 0,
                        stream>>>(tb, vbuf[i], sbuf[i], vbuf[i ^ 1],
                                  sbuf[i ^ 1], words, R1);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// tdesc on the device: [n, 2] int64 (k2, element offset in bp); carry [3]
// (i2, j2, r) in and out; rows [n, 4].
extern "C" int dg_chunk_trace(const long long* tdesc, int n,
                              const int32_t* bp, int32_t* carry,
                              int32_t* rows, cudaStream_t stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  chunk_trace_kernel<<<1, 32, 0, stream>>>(tdesc, n, bp, carry, rows);
  return (int)cudaGetLastError();
}
