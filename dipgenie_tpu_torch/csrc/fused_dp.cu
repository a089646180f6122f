// K13 fused_forward and K14 fused_trace: the fused DP tier.
//
// K13 replaces dipgenie_tpu/ops/diploid_fused.py `_forward_fn` (:462, one
// lax.scan over every transition, :492) and its body `_branch_step`
// (:306-414): per transition, a thread a state (r, i2, j2) of [R1, k2,
// k2] takes the transition's max (vertex_dp.cuh), writes V' and the
// winner's slot pair code p * P + q (int16 up to 256 slots, int32 past
// that, 0 where unreachable) at the transition's byte offset. The host
// entry launches one kernel a transition, V alternating between two
// global buffers. The TPU version padded every transition to a bucket of
// (B, P, W) and ran P x P gathers of the whole [R1, B, B] state; this one
// has no padding and visits each destination's real slots only.
//
// K14 replaces `_trace_fn` (:530-605): one thread walks the codes from the
// sink pair (0, 0) at r = R back to level 0, decodes each code through the
// slot table into (pi, pj, wu, wv), and adds popcount((Tl | Tl) ^ (Tr |
// Tr)) of the chosen pairs to s_het. r is clamped to 0, which only a walk
// from an unreachable sink needs.
//
// What bounds them on the H100: K13 reads each state's candidates' sources
// (gathers of V) and writes V' (4 B) and its code (2 or 4 B) per state;
// with one launch a transition, most of the MHC-scale graph's transitions
// (widths ~8, ~1,200 states) are bound by the launch itself. K14 is one
// dependent chain of global reads a transition. A simple design that is
// right first: a later PR makes them fast.
#include "vertex_dp.cuh"

namespace {

using namespace dgv;

__global__ void __launch_bounds__(THREADS)
fused_step_kernel(Tables t, const int32_t* __restrict__ vin,
                  int32_t* __restrict__ vout, char* __restrict__ bp,
                  int code32, int R1) {
  const long long n = (long long)R1 * t.k2 * t.k2;
  for (long long x = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       x < n; x += (long long)gridDim.x * blockDim.x) {
    int r, i2, j2;
    state_of(x, t.k2, r, i2, j2);
    const Win o = best_of(t, vin, r, i2, j2);
    vout[x] = o.v;
    const int code = o.v == NEG ? 0 : o.p * t.P + o.q;
    if (code32)
      reinterpret_cast<int32_t*>(bp)[x] = code;
    else
      reinterpret_cast<uint16_t*>(bp)[x] = (uint16_t)code;
  }
}

__global__ void fused_trace_kernel(const long long* __restrict__ desc, int T,
                                   int R, const int32_t* __restrict__ pred,
                                   const uint32_t* __restrict__ masks,
                                   const char* __restrict__ bp,
                                   int32_t* __restrict__ rows,
                                   int32_t* __restrict__ sh_out) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  int i2 = 0, j2 = 0, r = R, sh = 0;
  for (int t = T - 1; t >= 0; --t) {
    const long long* d = desc + (long long)t * DESC_COLS;
    const int k = (int)d[D_K], k2 = (int)d[D_K2], P = (int)d[D_P];
    const int W = (int)d[D_W];
    const long long x = ((long long)r * k2 + i2) * k2 + j2;
    const char* codes = bp + d[D_BP];
    const int code = P <= CODE16_SLOTS
        ? (int)reinterpret_cast<const uint16_t*>(codes)[x]
        : reinterpret_cast<const int32_t*>(codes)[x];
    const int p = code / P, q = code - p * P;
    const int32_t* slots = pred + d[D_PRED];
    const int ep = slots[(long long)i2 * P + p];
    const int eq = slots[(long long)j2 * P + q];
    const int a = ep >> 1, wu = ep & 1, b = eq >> 1, wv = eq & 1;
    const uint32_t* tl = masks + d[D_MASK] + (long long)k * W;
    const uint32_t* tr = tl + (long long)(k + k2) * W;
    for (int w = 0; w < W; ++w)
      sh += __popc((tl[(long long)a * W + w] | tl[(long long)b * W + w]) ^
                   (tr[(long long)i2 * W + w] | tr[(long long)j2 * W + w]));
    int32_t* row = rows + 4LL * t;
    row[0] = a;
    row[1] = b;
    row[2] = wu;
    row[3] = wv;
    i2 = a;
    j2 = b;
    r = r - wu - wv > 0 ? r - wu - wv : 0;
  }
  *sh_out = sh;
}

}  // namespace

// Transitions t0 .. t1 - 1, one launch each: V of transition t0 in va,
// the V after transition t0 + i in (i even ? vb : va). desc is the host
// descriptor table [T, DESC_COLS].
extern "C" int dg_fused_forward(const long long* desc, int t0, int t1, int R1,
                                const int32_t* pred, const int32_t* deg,
                                const uint32_t* masks, int32_t* va,
                                int32_t* vb, char* bp, cudaStream_t stream) {
  if (R1 < 1 || t0 < 0 || t1 < t0) return (int)cudaErrorInvalidValue;
  int32_t* buf[2] = {va, vb};
  for (int t = t0; t < t1; ++t) {
    const long long* d = desc + (long long)t * DESC_COLS;
    const Tables tb = tables_of(d, pred, deg, masks);
    const int i = (t - t0) & 1;
    fused_step_kernel<<<grid_of((long long)R1 * tb.k2 * tb.k2), THREADS, 0,
                        stream>>>(tb, buf[i], buf[i ^ 1], bp + d[D_BP],
                                  tb.P > CODE16_SLOTS, R1);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// desc on the device; rows [T, 4], sh_out [1].
extern "C" int dg_fused_trace(const long long* desc, int T, int R,
                              const int32_t* pred, const uint32_t* masks,
                              const char* bp, int32_t* rows, int32_t* sh_out,
                              cudaStream_t stream) {
  if (T < 0 || R < 0) return (int)cudaErrorInvalidValue;
  fused_trace_kernel<<<1, 32, 0, stream>>>(desc, T, R, pred, masks, bp, rows,
                                           sh_out);
  return (int)cudaGetLastError();
}
