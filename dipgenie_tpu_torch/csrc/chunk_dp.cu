// K15 chunk_step and K16 chunk_trace: the chunked DP tier.
//
// K15 replaces dipgenie_tpu/ops/diploid_jax.py `_step_body` (:177-272),
// run by `_scan_fn` (:440-464, lax.scan chunks of up to 512 small
// transitions padded with no-op steps) and `_big_fn` (:466-484, one
// transition padded to a (B, P, W) bucket): per transition, each state
// (r, i2, j2) takes the max of vertex_dp.cuh and carries SH, the winner's
// source SH plus its popcount((Tl | Tl) ^ (Tr | Tr)) (0 where
// unreachable). On the traceback's replay it also writes the packed
// backpointer pi | pj << 12 | wu << 24 | wv << 25 (0 where unreachable),
// each transition's words right after the previous one's. The host entry
// launches what ops/vertex_plan.py:plan_launches cut, as K13 does
// (fused_dp.cu): a run of narrow transitions with V and SH in shared
// memory is one launch, a wide transition one launch of the
// per-transition kernel, whose SH is read from global memory once a state
// (the winner's source); no padding, no no-op steps.
//
// Over a tp mesh (ops/chunked.py:chunk_step_tp; the JAX tier sharded its
// state over the destination rows, parallel/mesh.py:90-109) the host
// drives the cut launch by launch, since a collective sits between two
// launches: a run is dg_chunk_forward on a one-row cut, the same on every
// rank; a wide transition is dg_chunk_step_share, the per-transition
// kernel on this rank's destination pairs [p0, p1), its V', SH' and words
// into compact [R1, pitch] buffers that one all-gather collects.
//
// K16 replaces `_trace_fn` (:543-567): the walk of a replayed span's
// packed words in reverse from the carry (i2, j2, r) in device memory,
// leaving the carry for the span before it. It is the staged walk of
// vertex_trace.cuh: the span passes only (t0, t1); each transition's
// width comes from the descriptors on the card and its first word from
// one int64 table of the plan (the tier makes it once); a producer warp
// bulk-copies the rows [r - 2, r] of each transition's words into a
// shared-memory ring a batch ahead, so that the walker's step is one
// shared-memory read where the transition is staged, an L2 read after a
// prefetch where it is not.
//
// What bounds them on the H100: K15 as K13 (fused_dp.cu), plus SH (4 B a
// state in and out) and, on replay, the packed word (4 B a state); K16 is
// one serial chain, its bytes (~36 a transition) nothing: the walker's
// instructions and the launch a span set its pace. Measured (PERF.md
// section 6, NVIDIA H100 80GB HBM3, 700 W): C's first 2,000 transitions as
// one span in 0.200 ms against the replaced one-thread walker's 0.595 in
// the same run, ~123 SM cycles a staged step; C's chunked traceback
// 0.411 s against 0.802 (its walks 21 ms, its replays 394).
#include "vertex_trace.cuh"

using namespace dgv;

// The launches of a host cut (cut [n_launch, 3] over transitions t0 ..,
// ops/vertex_plan.py:plan_launches) over the host descriptor table desc
// and its device copy desc_dev: (V, SH) before the first launch in (va,
// sa), after launch i in (i even ? (vb, sb) : (va, sa)). With bp, bp_off
// (host, one int64 a transition from t0) gives each transition's element
// offset in bp; a run's transitions lie one after another.
extern "C" int dg_chunk_forward(const long long* desc,
                                const long long* desc_dev,
                                const long long* cut, int n_launch, int t0,
                                int R1, const int32_t* pred,
                                const int32_t* deg, const uint32_t* masks,
                                int32_t* va, int32_t* vb, int32_t* sa,
                                int32_t* sb, int32_t* bp,
                                const long long* bp_off, cudaStream_t stream) {
  if (bp != nullptr && bp_off == nullptr) return (int)cudaErrorInvalidValue;
  auto words = [&](long long t) {
    return bp != nullptr ? reinterpret_cast<char*>(bp + bp_off[t - t0])
                         : nullptr;
  };
  return launch_cut<true>(desc, desc_dev, cut, n_launch, R1, pred, deg,
                          masks, va, vb, sa, sb, words, words, stream);
}

// One wide transition on the destination pairs [p0, p1) of its k2 * k2:
// desc_row the transition's host descriptor row; vin, shin [R1, k, k]; state
// (r, pair) to element r * pitch + pair - p0 of vout, shout and words (or
// null: no words). An empty range launches nothing.
extern "C" int dg_chunk_step_share(const long long* desc_row,
                                   const int32_t* pred, const int32_t* deg,
                                   const uint32_t* masks, const int32_t* vin,
                                   const int32_t* shin, int32_t* vout,
                                   int32_t* shout, int32_t* words,
                                   long long p0, long long p1,
                                   long long pitch, int R1,
                                   cudaStream_t stream) {
  const Tables tb = tables_of(desc_row, pred, deg, masks);
  const long long kk2 = (long long)tb.k2 * tb.k2;
  if (R1 < 1 || p0 < 0 || p1 < p0 || p1 > kk2 || pitch < p1 - p0)
    return (int)cudaErrorInvalidValue;
  if (p1 == p0) return 0;
  return (int)launch_step<true>(tb, vin, vout, shin, shout,
                                reinterpret_cast<char*>(words), R1, p0, p1,
                                pitch, stream);
}

// The walk of transitions t0 .. t0 + n - 1: desc_dev [T, DESC_COLS];
// woff [T + 1] int64 on the device, transition t's words at bp[woff[t] -
// woff[t0]] (bp holds nwords); carry [3] (i2, j2, r) in and out; rows
// [n, 4] (16-byte aligned); cyc [n] or null (the walker's cycles a
// transition << 1 | its word was staged).
extern "C" int dg_chunk_trace(const long long* desc_dev,
                              const long long* woff, int t0, int n,
                              const int32_t* bp, long long nwords,
                              int32_t* carry, int32_t* rows, int32_t* cyc,
                              cudaStream_t stream) {
  if (n < 0 || t0 < 0) return (int)cudaErrorInvalidValue;
  dgt::Args g = {};
  g.desc = desc_dev;
  g.blk = (const char*)bp;
  g.blk_end = (const char*)(bp + nwords);
  g.woff = woff;
  g.t0 = t0;
  g.T = n;
  g.carry = carry;
  g.rows = rows;
  g.cyc = cyc;
  return dgt::launch_walk<false>(g, stream);
}
