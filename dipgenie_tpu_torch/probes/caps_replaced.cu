// The capability checks' kernels as they were before their redesign for
// Hopper, for the timings in turns of phase H2 (chip_smoke.py) only: the
// sublane gathers (one block of 1,024 threads staging all of A), the
// mma.sync products (each k-step's fragments loaded inside the product
// loop; dot2d_f32 4 warps a block, batched_dot_3d 2), and dma_strided_3d
// (the copy started after the block's barrier, the store a bulk copy, the
// TMA map encoded on the host every call). Built on its own into
// build/dipgenie_tpu_torch/caps_replaced/ by probes/caps_replaced.py; no
// other path of the package loads it. Entry point dg_caps_replaced, the
// check ids of csrc/caps.cuh; every other id returns caps::NOT_MINE.
#include <cuda.h>

#include "caps.cuh"

namespace {

constexpr int R1 = 19;

// [ROWS, 128]: out[i, j] = A[idx[i, j], j]. One block, A in shared memory.
template <int ROWS>
__global__ void __launch_bounds__(1024)
replaced_caps_sublane_gather(const int32_t* __restrict__ A,
                    const int32_t* __restrict__ idx,
                    int32_t* __restrict__ out) {
  __shared__ int32_t s[ROWS * 128];
  for (int i = threadIdx.x; i < ROWS * 128; i += blockDim.x) s[i] = A[i];
  __syncthreads();
  for (int i = threadIdx.x; i < ROWS * 128; i += blockDim.x)
    out[i] = s[(idx[i] & (ROWS - 1)) * 128 + (i & 127)];
}

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
replaced_caps_batched_dot(const float* __restrict__ A, const float* __restrict__ B,
                 float* __restrict__ C, int a_stride) {
  const int r = blockIdx.x, n0 = threadIdx.x / 32 * 8;
  warp_tile(A + r * a_stride, 32, B + r * 32 * 16 + n0, 16,
            C + r * 16 * 16 + n0, 16, 32);
}


// [64, 32] @ [32, 304]: block b owns columns 8b..8b+7, warp w rows
// 16w..16w+15 (4 x 38 tiles).
__global__ void __launch_bounds__(128)
replaced_caps_dot2d(const float* __restrict__ A, const float* __restrict__ B,
           float* __restrict__ C) {
  const int m0 = threadIdx.x / 32 * 16, n0 = blockIdx.x * 8;
  warp_tile(A + m0 * 32, 32, B + n0, 304, C + m0 * 304 + n0, 304, 32);
}

__device__ __forceinline__ uint32_t smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One thread sets the barrier up for one arrival; the caller then syncs
// the threads that will wait on it. The fence is CUTLASS's
// fence_barrier_init (cutlass/arch/barrier.h): it makes the init visible
// across the warps, the block and the cluster (a launch without cluster
// dimensions is a cluster of one) when composed with a sync of that scope.
__device__ __forceinline__ void barrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void expect_bytes(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem(bar)),
               "r"(bytes)
               : "memory");
}

// Every thread waits for phase 0 of the barrier to complete.
__device__ __forceinline__ void wait_phase0(uint64_t* bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem(bar)), "r"(0u)
        : "memory");
  }
}

// Every thread that wrote shared memory the bulk store reads makes its
// writes visible to the async proxy, then the caller syncs those threads.
__device__ __forceinline__ void fence_to_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Shared -> global, `bytes`, by one thread, which waits until the copy has
// read shared memory (wait_group.read): the block's shared memory must
// outlive that read, and the end of the grid makes the writes visible.
// Waiting for the writes themselves (wait_group 0) took the same time.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(smem(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// out [19, 8, 8] = A[slab, :, :8, :8] + 1 of A [4, 19, 16, 16] int16,
// loaded by one TMA tensor copy.
__global__ void __launch_bounds__(256)
replaced_caps_dma_strided(const __grid_constant__ CUtensorMap tmap,
                 int16_t* __restrict__ out, int slab) {
  constexpr uint32_t BYTES = 19 * 8 * 8 * 2;
  __shared__ __align__(128) int16_t s[19 * 8 * 8];
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x == 0) barrier_init(&bar);
  __syncthreads();
  if (threadIdx.x == 0) {
    expect_bytes(&bar, BYTES);
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem(s)),
        "l"(reinterpret_cast<uint64_t>(&tmap)), "r"(0), "r"(0),
        "r"(slab * 19), "r"(smem(&bar))
        : "memory");
  }
  wait_phase0(&bar);
  for (int i = threadIdx.x; i < 19 * 8 * 8; i += blockDim.x)
    s[i] = (int16_t)(s[i] + 1);
  fence_to_async();
  __syncthreads();
  if (threadIdx.x == 0) bulk_store(out, s, BYTES);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up at run time, or null.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return rc == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of A [4, 19, 16, 16] int16 seen as [76, 16, 16], box [19, 8, 8].
int strided_corner_map(const void* A, CUtensorMap* tmap) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {16, 16, 4 * 19};
  const cuuint64_t strides[2] = {16 * 2, 16 * 16 * 2};  // bytes, dims 1, 2
  const cuuint32_t box[3] = {8, 8, 19};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult rc = encode(
      tmap, CU_TENSOR_MAP_DATA_TYPE_UINT16, 3, const_cast<void*>(A), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int dg_caps_replaced(int check, const void* in0, const void* in1,
                                void* out, int arg, cudaStream_t s) {
  using namespace caps;
  const auto* a = static_cast<const int32_t*>(in0);
  const auto* b = static_cast<const int32_t*>(in1);
  const auto* fa = static_cast<const float*>(in0);
  const auto* fb = static_cast<const float*>(in1);
  switch (check) {
    case SUBLANE_GATHER_8:
      replaced_caps_sublane_gather<8><<<1, 1024, 0, s>>>(a, b,
                                                static_cast<int32_t*>(out));
      break;
    case SUBLANE_GATHER_16:
      replaced_caps_sublane_gather<16><<<1, 1024, 0, s>>>(a, b,
                                                 static_cast<int32_t*>(out));
      break;
    case BATCHED_DOT_3D:
      replaced_caps_batched_dot<<<R1, 64, 0, s>>>(fa, fb, static_cast<float*>(out),
                                         16 * 32);
      break;
    case BATCHED_DOT_BCAST_LHS:
      replaced_caps_batched_dot<<<R1, 64, 0, s>>>(fa, fb, static_cast<float*>(out), 0);
      break;
    case DOT2D_F32:
      replaced_caps_dot2d<<<304 / 8, 128, 0, s>>>(fa, fb, static_cast<float*>(out));
      break;
    case DMA_STRIDED_3D: {
      if (arg < 0 || arg > 3) return (int)cudaErrorInvalidValue;
      CUtensorMap tmap;
      const int rc = strided_corner_map(in0, &tmap);
      if (rc != 0) return rc;
      replaced_caps_dma_strided<<<1, 256, 0, s>>>(tmap, static_cast<int16_t*>(out),
                                         arg);
      break;
    }
    default:
      return NOT_MINE;
  }
  return (int)cudaGetLastError();
}
