// K13 fused_forward and K14 fused_trace: the fused DP tier.
//
// K13 replaces dipgenie_tpu/ops/diploid_fused.py `_forward_fn` (:462, one
// lax.scan over every transition, :492) and its body `_branch_step`
// (:306-414): per transition, each state (r, i2, j2) of [R1, k2, k2] takes
// the transition's max (vertex_dp.cuh), writes V' and the winner's slot
// pair code p * P + q (int16 up to 256 slots, int32 past that, 0 where
// unreachable) at the transition's byte offset. The host entry launches
// what ops/vertex_plan.py:plan_launches cut: a run of narrow transitions is
// one launch of the run kernel (one block, V in shared memory), a wide
// transition one launch of the per-transition kernel (V in global memory);
// both walk each destination pair's real slot pairs once and score each
// candidate once for all its rows. The TPU version padded every transition
// to a bucket of (B, P, W) and ran P x P gathers of the whole [R1, B, B]
// state; this one has no padding.
//
// K14 replaces `_trace_fn` (:530-605): the walk of the codes from the
// sink pair (0, 0) at r = R back to level 0, each code decoded through the
// slot table into a row (pi, pj, wu, wv), and s_het, the sum of the
// chosen pairs' popcount((Tl | Tl) ^ (Tr | Tr)). r is clamped to 0, which
// only a walk from an unreachable sink needs. It is the staged walk of
// vertex_trace.cuh: a producer warp bulk-copies each transition's code
// rows [r - 2, r] and its slot table into a shared-memory ring a batch
// ahead; the walker's step is one code read, a multiply-high by the
// reciprocal of P and two slot reads, all from shared memory where the
// transition is staged (C's narrow levels), from L2 after a prefetch where
// it is not (its 33-96-wide levels); a recorder warp adds s_het and stores
// the rows, off the walker's chain.
//
// What bounds them on the H100: K13 reads each level's tables and writes
// V' (4 B) and its code (2 or 4 B) per state; on the MHC-scale graph's
// narrow runs (widths ~8, ~1,200 states a level) a level is a short chain
// on one SM (vertex_dp.cuh). K14 is one serial chain, its bytes (~100 a
// transition) nothing: the walker's instructions and, on transitions not
// staged, an L2 round trip set its pace. Measured (PERF.md section 6,
// NVIDIA H100 80GB HBM3, 700 W): C's whole plan in 13.55 ms against the
// replaced one-thread walker's 184.30 ms in the same run (W 13.10 against
// 182.16); ~229 SM cycles a staged step, ~660 through L2.
#include "vertex_trace.cuh"

using namespace dgv;

// The launches of a host cut (cut [n_launch, 3], ops/vertex_plan.py:
// plan_launches) over the host descriptor table desc and its device copy
// desc_dev [T, DESC_COLS]: V before the first launch in va, after launch i
// in (i even ? vb : va); each transition's codes at its byte offset in bp.
extern "C" int dg_fused_forward(const long long* desc,
                                const long long* desc_dev,
                                const long long* cut, int n_launch, int R1,
                                const int32_t* pred, const int32_t* deg,
                                const uint32_t* masks, int32_t* va,
                                int32_t* vb, char* bp, cudaStream_t stream) {
  return launch_cut<false>(
      desc, desc_dev, cut, n_launch, R1, pred, deg, masks, va, vb, nullptr,
      nullptr, [&](long long t) { return bp + desc[t * DESC_COLS + D_BP]; },
      [&](long long) { return bp; }, stream);
}

// The shared memory a block may opt in to on the current device (the
// budget of plan_launches).
extern "C" int dg_vertex_smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  return (int)e;
}

// desc_dev [T, DESC_COLS]; pred (npred words) and bp (nbytes) as the
// forward left them; rows [T, 4] (16-byte aligned), sh [1]; cyc [T] or
// null (the walker's cycles a transition << 1 | its code was staged).
extern "C" int dg_fused_trace(const long long* desc_dev, int T, int R,
                              const int32_t* pred, long long npred,
                              const uint32_t* masks, const char* bp,
                              long long nbytes, int32_t* rows, int32_t* sh,
                              int32_t* cyc, cudaStream_t stream) {
  if (T < 0 || R < 0) return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaMemsetAsync(sh, 0, sizeof(int32_t), stream);
  dgt::Args g = {};
  g.desc = desc_dev;
  g.blk = bp;
  g.blk_end = bp + nbytes;
  g.pred = pred;
  g.pred_end = pred + npred;
  g.masks = masks;
  g.T = T;
  g.R = R;
  g.rows = rows;
  g.sh = sh;
  g.cyc = cyc;
  return dgt::launch_walk<true>(g, stream);
}
