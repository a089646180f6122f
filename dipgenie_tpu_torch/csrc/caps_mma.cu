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
// The operands are read straight from device memory (row-major A and B):
// each is read once per tile.
#include "caps.cuh"

namespace {

constexpr int R1 = 19;

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

struct FragA {
  uint32_t x[4];
};

// The A fragment of the 16 x 8 block of A (row-major, leading dimension
// lda) whose top-left element is at A.
__device__ __forceinline__ FragA load_a(const float* A, int lda) {
  const int g = threadIdx.x % 32 / 4, q = threadIdx.x % 4;
  return {{tf32(A[g * lda + q]), tf32(A[(g + 8) * lda + q]),
           tf32(A[g * lda + q + 4]), tf32(A[(g + 8) * lda + q + 4])}};
}

// d += a @ b for the 8 x 8 block of B (row-major, leading dimension ldb)
// whose top-left element is at B.
__device__ __forceinline__ void mma_step(float (&d)[4], const FragA& a,
                                         const float* B, int ldb) {
  const int g = threadIdx.x % 32 / 4, q = threadIdx.x % 4;
  const uint32_t b0 = tf32(B[q * ldb + g]), b1 = tf32(B[(q + 4) * ldb + g]);
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x[0]), "r"(a.x[1]), "r"(a.x[2]), "r"(a.x[3]), "r"(b0), "r"(b1));
}

// Stores the 16 x 8 accumulator tile at C (leading dimension ldc).
__device__ __forceinline__ void store_c(float* C, int ldc,
                                        const float (&d)[4]) {
  const int g = threadIdx.x % 32 / 4, q = threadIdx.x % 4;
  C[g * ldc + 2 * q] = d[0];
  C[g * ldc + 2 * q + 1] = d[1];
  C[(g + 8) * ldc + 2 * q] = d[2];
  C[(g + 8) * ldc + 2 * q + 1] = d[3];
}

// The 16 x 8 tile C = A @ B of a 16 x K block row of A and a K x 8 block
// column of B, one warp.
__device__ __forceinline__ void warp_tile(const float* A, int lda,
                                          const float* B, int ldb, float* C,
                                          int ldc, int K) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < K; k += 8)
    mma_step(d, load_a(A + k, lda), B + k * ldb, ldb);
  store_c(C, ldc, d);
}

// [19, 16, 32] @ [19, 32, 16]: block r, warp w computes columns 8w..8w+7
// of row r, with 4 mma.sync. a_stride is the distance between the rows' A
// matrices: 16 * 32, or 0 for one [16, 32] broadcast over the 19 rows
// (batched_dot_bcast_lhs: each warp loads the one-hot's four A fragments,
// L2-resident after the first block, so the 19 rows run in parallel; one
// block of 19 warps with the one-hot staged in shared memory measured 2.1x
// slower on the H100, and two warps walking the rows in turn 4.6x).
__global__ void __launch_bounds__(64)
caps_batched_dot(const float* __restrict__ A, const float* __restrict__ B,
                 float* __restrict__ C, int a_stride) {
  const int r = blockIdx.x, n0 = threadIdx.x / 32 * 8;
  warp_tile(A + r * a_stride, 32, B + r * 32 * 16 + n0, 16,
            C + r * 16 * 16 + n0, 16, 32);
}


// [64, 32] @ [32, 304]: block b owns columns 8b..8b+7, warp w rows
// 16w..16w+15 (4 x 38 tiles).
__global__ void __launch_bounds__(128)
caps_dot2d(const float* __restrict__ A, const float* __restrict__ B,
           float* __restrict__ C) {
  const int m0 = threadIdx.x / 32 * 16, n0 = blockIdx.x * 8;
  warp_tile(A + m0 * 32, 32, B + n0, 304, C + m0 * 304 + n0, 304, 32);
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
      caps_batched_dot<<<R1, 64, 0, s>>>(a, b, c, 16 * 32);
      break;
    case BATCHED_DOT_BCAST_LHS:
      caps_batched_dot<<<R1, 64, 0, s>>>(a, b, c, 0);
      break;
    case DOT2D_F32:
      caps_dot2d<<<304 / 8, 128, 0, s>>>(a, b, c);
      break;
    default:
      return NOT_MINE;
  }
  return (int)cudaGetLastError();
}
