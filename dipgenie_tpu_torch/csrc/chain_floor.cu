// K5a: the empty-body level chain of the floor probe.
//
// Replaces scripts/tpu_floor_probe.py `build_pallas0`: a sequential TPU
// grid of T steps, each streaming a [8, 128] int32 block in, adding it to
// an accumulator kept in VMEM scratch and writing the accumulator's low 15
// bits out as an int16 block.
//
// What bounds it on the H100: one block on one of 132 SMs moves 6 KB per
// level, so neither the card's bytes/s nor its operations/s come near; the
// cost per level is what a single block pays for one 4-byte load and one
// 2-byte store per thread, which the hardware overlaps across levels
// because nothing but the register accumulator links them. That is the
// floor a level chain with an empty body has on this card.
//
// Design: the TPU's sequential grid becomes a loop inside ONE block of
// 1,024 threads, one element each, the accumulator in a register; one
// launch per chain. The body needs no barrier, so there is none: the
// chains with a body (chain_step16.cu, chain_pair.cu, chain_edge.cu) show
// what barriers and a shared-memory state add. The sum wraps like int32.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 8 * 128;

__global__ void __launch_bounds__(LANES)
chain_floor_kernel(const int32_t* __restrict__ tbl, int T,
                   int16_t* __restrict__ bp, int32_t* __restrict__ acc_out) {
  const int i = threadIdx.x;
  unsigned acc = 0;
  for (int t = 0; t < T; ++t) {
    acc += (unsigned)tbl[(size_t)t * LANES + i];
    bp[(size_t)t * LANES + i] = (int16_t)(acc & 0x7FFFu);
  }
  acc_out[i] = (int32_t)acc;
}

}  // namespace

extern "C" int dg_chain_floor(const int32_t* tbl, int T, int16_t* bp,
                              int32_t* acc_out, cudaStream_t stream) {
  chain_floor_kernel<<<1, LANES, 0, stream>>>(tbl, T, bp, acc_out);
  return (int)cudaGetLastError();
}
