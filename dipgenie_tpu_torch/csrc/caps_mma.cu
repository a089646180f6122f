// Capability checks, the product family: float32 matrix products on the
// tensor cores with mma.sync.
//
// Replaces these checks of scripts/tpu_caps_probe2.py, which asked whether
// Mosaic lowers a dot to the TPU's matrix unit at these shapes:
//   mk_batched_dot (:43): einsum("rij,rjk->rik") of [19, 16, 32] and
//     [19, 32, 16];
//   mk_batched_dot_bcast_lhs (:62): a one-hot [16, 32] broadcast over the
//     19 rows of V [19, 32, 16], i.e. V[:, sel, :] as a product (the one-hot
//     products the DP kernels used the matrix unit for);
//   mk_dot2d_f32 (:294): [64, 32] @ [32, 304].
//
// What bounds them on the H100: 0.3-1.3 MFLOP (under 3 ns at TF32's 495
// TFLOP/s) and 97-125 KB (29-37 ns at 3.35 TB/s); the launch costs
// microseconds. The primitive probed is mma.sync.aligned.m16n8k8 with TF32
// inputs and a float32 accumulator: one warp owns a 16 x 8 output tile and
// walks K in steps of 8. The inputs are small integers (0..99), so TF32's
// 10-bit mantissa holds them exactly and every sum (at most 32 x 99) is
// exact in float32: the output equals numpy's.
//
// Fragments of m16n8k8 TF32 (PTX ISA, "Matrix Fragments for mma.m16n8k8"),
// with g = lane / 4 and q = lane % 4:
//   A (16 x 8, row): a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4)
//   B (8 x 8, col):  b0 (q, g), b1 (q + 4, g)
//   C (16 x 8):      c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8, 2q), c3 (g + 8, 2q + 1)
// The kernels these replace loaded each k-step's fragments from device
// memory inside the product loop and ran 4 warps a block for dot2d_f32, 2
// for batched_dot_3d: 1.783 / 1.524 us of device time on an H100 80GB
// HBM3 at 700 W (PERF.md section 6). Knock-outs on that card (PERF.md
// section 6) put ~0.5 us of a launch in the operands' loads, ~0.15-0.2 in
// the products and the TF32 rounding, ~0.1 in the stores, over the
// ~0.86 us of an empty launch; staging the operands with 16-byte loads
// took 0.03-0.16 us off the loads.
#include "caps.cuh"

namespace {

constexpr int R1 = 19;

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// C = A @ B for the 16 x 8 tile whose 16 x 32 block of A starts at A
// (row-major, leading dimension lda) and whose 32 x 8 block of B starts at
// B (ldb), one warp: the two blocks come in with 16-byte loads (4 + 2 a
// lane, every one issued before the first is stored) into the warp's slots
// of shared memory (A's rows padded to 36 floats, so that a fragment read
// hits 32 banks), then the four k-steps' fragments are read from there and
// the products run back to back. The tile is stored as two float2 a lane.
// Every address is 16-byte aligned: the bases are (the wrapper checks),
// and lda, ldb and the blocks' offsets are multiples of 4 floats.
constexpr int TILE_WARPS = 2;  // warps a block at most

__device__ __forceinline__ void warp_tile(const float* __restrict__ A,
                                          int lda,
                                          const float* __restrict__ B,
                                          int ldb, float* __restrict__ C,
                                          int ldc) {
  __shared__ __align__(16) float sA[TILE_WARPS][16][36];
  __shared__ __align__(16) float sB[TILE_WARPS][32][8];
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  float4 va[4], vb[2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // A: 16 rows of 8 float4
    const int x = lane + 32 * j;
    va[j] = *reinterpret_cast<const float4*>(A + x / 8 * lda + 4 * (x % 8));
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {  // B: 32 rows of 2 float4
    const int x = lane + 32 * j;
    vb[j] = *reinterpret_cast<const float4*>(B + x / 2 * ldb + 4 * (x % 2));
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int x = lane + 32 * j;
    *reinterpret_cast<float4*>(&sA[w][x / 8][4 * (x % 8)]) = va[j];
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int x = lane + 32 * j;
    *reinterpret_cast<float4*>(&sB[w][x / 2][4 * (x % 2)]) = vb[j];
  }
  __syncwarp();
  float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 4; ++k)
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(tf32(sA[w][g][8 * k + q])), "r"(tf32(sA[w][g + 8][8 * k + q])),
          "r"(tf32(sA[w][g][8 * k + q + 4])),
          "r"(tf32(sA[w][g + 8][8 * k + q + 4])),
          "r"(tf32(sB[w][8 * k + q][g])), "r"(tf32(sB[w][8 * k + q + 4][g])));
  *reinterpret_cast<float2*>(C + g * ldc + 2 * q) = make_float2(d[0], d[1]);
  *reinterpret_cast<float2*>(C + (g + 8) * ldc + 2 * q) =
      make_float2(d[2], d[3]);
}

// [19, 16, 32] @ [19, 32, 16]: 38 tiles of 16 x 8, tile u row u / 2,
// columns 8 (u % 2) .. + 7, one warp a tile. A_STRIDE is the distance
// between the rows' A matrices: 16 * 32, or 0 for one [16, 32] broadcast
// over the 19 rows (batched_dot_bcast_lhs: each warp loads the one-hot's
// fragments, L2-resident after the first block, so the 19 rows run in
// parallel; one block of 19 warps with the one-hot staged in shared memory
// measured 2.1x slower on the H100, and two warps walking the rows in turn
// 4.6x). batched_dot_3d runs a warp a block (38 blocks, 38 SMs),
// batched_dot_bcast_lhs two (19 blocks), the geometry of its timings.
// WARPS sets the launch bound: at 64 threads ptxas gives the kernel 32
// registers and puts shared-memory stores between the operands' loads,
// each store waiting for its load (three round trips, not one): 1.50 us of
// device time for batched_dot_3d, 1.32 at a bound of 32 threads (H100 80GB
// HBM3 at 700 W).
template <int A_STRIDE, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
caps_batched_dot(const float* __restrict__ A, const float* __restrict__ B,
                 float* __restrict__ C) {
  const int u = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int r = u >> 1, n0 = (u & 1) * 8;
  warp_tile(A + r * A_STRIDE, 32, B + r * 32 * 16 + n0, 16,
            C + r * 16 * 16 + n0, 16);
}

// [64, 32] @ [32, 304]: 152 tiles of 16 x 8, tile u rows 16 (u % 4) ..,
// columns 8 (u / 4) ..; a warp a block, so the tiles spread over the SMs.
__global__ void __launch_bounds__(32)
caps_dot2d(const float* __restrict__ A, const float* __restrict__ B,
           float* __restrict__ C) {
  const int m0 = blockIdx.x % 4 * 16, n0 = blockIdx.x / 4 * 8;
  warp_tile(A + m0 * 32, 32, B + n0, 304, C + m0 * 304 + n0, 304);
}

}  // namespace

int caps::mma(int check, const void* in0, const void* in1, void* out,
              int arg, cudaStream_t s) {
  (void)arg;
  const auto* a = static_cast<const float*>(in0);
  const auto* b = static_cast<const float*>(in1);
  auto* c = static_cast<float*>(out);
  switch (check) {
    case BATCHED_DOT_3D:
      caps_batched_dot<16 * 32, 1><<<2 * R1, 32, 0, s>>>(a, b, c);
      break;
    case BATCHED_DOT_BCAST_LHS:
      caps_batched_dot<0, 2><<<R1, 64, 0, s>>>(a, b, c);
      break;
    case DOT2D_F32:
      caps_dot2d<<<4 * (304 / 8), 32, 0, s>>>(a, b, c);
      break;
    default:
      return NOT_MINE;
  }
  return (int)cudaGetLastError();
}
