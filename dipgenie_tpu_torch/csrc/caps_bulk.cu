// Capability checks, the bulk-copy family: copies between device memory and
// shared memory that the hardware runs on its own, completed on mbarriers.
//
// Replaces these checks, the TPU's manual DMAs (pltpu.make_async_copy with
// DMA semaphores on pltpu.ANY operands):
//   scripts/tpu_caps_probe.py mk_manual_dma (:186): A[8:24] + 1 of a
//     [64, 128] int32 array, copied in at a row offset and back out;
//   scripts/tpu_caps_probe2.py mk_dma_strided_3d (:202): the [19, 8, 8]
//     corner of slab 2 of a [4, 19, 16, 16] int16 array, + 1;
//   scripts/tpu_caps_probe2.py mk_dma_in_when (:265): slab 2 of a
//     [4, 8, 128] int32 array, copied in only under program_id == 0.
//
// What bounds them on the H100: 2.4-16 KB each, 1-5 ns at 3.35 TB/s; the
// cost is latency. On an H100 80GB HBM3 at 700 W (device time by the
// profiler): an empty one-warp kernel takes 0.87 us; a bulk load of 512 B
// or 4 KB and its wait add 0.32 us to it, a plain ld.global of the same
// bytes 0.19 us. The difference is the barrier's set-up: mbarrier.init,
// arrive.expect_tx and the cp.async.bulk instruction take 230-300 SM
// cycles before the copy starts (clock64), and the copy then lands in
// ~300 against ~360 for a plain load. The store's wait costs nothing
// measurable (wait_group 0 and wait_group.read alike), and one block of
// 16 warps moving 8 KB through one barrier took 0.2 us more than 16
// one-warp blocks of 512 B. The primitives probed are the ones the DP
// kernels' prefetch would use:
//   * cp.async.bulk global -> shared at an offset passed at run time, the
//     mbarrier armed with expect_tx by the issuing thread and waited on by
//     all (try_wait.parity), then fence.proxy.async so that the bulk store
//     shared -> global (bulk_group, commit_group, wait_group.read) sees the
//     threads' writes;
//   * a TMA tensor load (cp.async.bulk.tensor.3d) through a CUtensorMap of
//     A seen as [76, 16, 16] int16 with box {8, 8, 19} (innermost first):
//     the strided corner lands dense in shared memory. The map is encoded
//     here on the host with cuTensorMapEncodeTiled, found through
//     cudaGetDriverEntryPoint (no -lcuda), and passed as a __grid_constant__
//     kernel parameter. It is encoded again only when A's address
//     changes;
//   * a bulk copy started under a run-time condition, the barrier armed for
//     0 bytes where the condition does not hold, then plain stores.
// TMA wants 16-byte aligned global addresses and strides and a 128-byte
// aligned shared destination; the wrapper passes the tensor's base (which
// it checks for 16-byte alignment) and the offset, never a sliced pointer.
#include <cuda.h>

#include <mutex>

#include "caps.cuh"

namespace {

__device__ __forceinline__ uint32_t smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One thread sets the barrier up for one arrival; the caller then syncs
// the threads that will wait on it. The fence is CUTLASS's
// fence_barrier_init (cutlass/arch/barrier.h): it makes the init visible
// across the warps, the block and the cluster (a launch without cluster
// dimensions is a cluster of one) when composed with a sync of that scope.
// ptxas emits it as a NOP for sm_90a; fence.proxy.async.shared::cta in its
// place adds a MEMBAR.ALL.CTA, 0.015-0.03 us on the H100 above.
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

// Global -> shared, `bytes` (a multiple of 16) completed on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem(dst)),
      "l"(src), "r"(bytes), "r"(smem(bar))
      : "memory");
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

constexpr uint32_t ROW_BYTES = 128 * 4;  // one int32 row: one int4 a lane

// caps_manual_dma and caps_dma_in_when compute their addresses before
// mbarrier.init: the asm's memory clobber keeps a load of a kernel
// parameter written after it from moving up, which put that load between
// the init and the copy.

// out [16, 128] = A[row:row + 16] + 1 of A [64, 128] int32: 16 blocks of
// one warp, block b one row (one block of 16 warps took 1.38-1.39 us on
// the H100 above, 16 blocks 1.16-1.18). Lane 0 sets the block's barrier
// up and bulk-loads row `row + b` (the offset comes at run time); the warp
// waits, adds, fences, syncs; lane 0 bulk-stores the row.
__global__ void __launch_bounds__(32)
caps_manual_dma(const int32_t* __restrict__ A, int32_t* __restrict__ out,
                int row) {
  __shared__ __align__(128) int4 s[32];
  __shared__ __align__(8) uint64_t bar;
  const int lane = threadIdx.x;
  const int32_t* src = A + (size_t)(row + blockIdx.x) * 128;
  int32_t* dst = out + (size_t)blockIdx.x * 128;
  if (lane == 0) {
    barrier_init(&bar);
    expect_bytes(&bar, ROW_BYTES);
    bulk_load(s, src, ROW_BYTES, &bar);
  }
  __syncwarp();
  wait_phase0(&bar);
  const int4 v = s[lane];
  s[lane] = make_int4(v.x + 1, v.y + 1, v.z + 1, v.w + 1);
  fence_to_async();
  __syncwarp();
  if (lane == 0) bulk_store(dst, s, ROW_BYTES);
}

// out [19, 8, 8] = A[slab, :, :8, :8] + 1 of A [4, 19, 16, 16] int16,
// loaded by one TMA tensor copy: thread 0 sets the barrier up and starts
// the copy before the block's barrier; then each of 152 threads adds 1 to
// its 16 bytes (8 int16, two to a word: __vadd2 keeps each half's carry in
// it) and stores them with one 16-byte store. (The kernel this replaces
// started the copy after the block's barrier and stored through shared
// memory with a bulk copy: 1.436 us of device time on an H100 80GB HBM3 at
// 700 W, PERF.md section 6.)
constexpr uint32_t CORNER_BYTES = 19 * 8 * 8 * 2;  // 152 x 16 bytes

__global__ void __launch_bounds__(160)
caps_dma_strided(const __grid_constant__ CUtensorMap tmap,
                 int4* __restrict__ out, int slab) {
  __shared__ __align__(128) int4 s[CORNER_BYTES / 16];
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x == 0) {
    barrier_init(&bar);
    expect_bytes(&bar, CORNER_BYTES);
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem(s)),
        "l"(reinterpret_cast<uint64_t>(&tmap)), "r"(0), "r"(0),
        "r"(slab * 19), "r"(smem(&bar))
        : "memory");
  }
  __syncthreads();
  wait_phase0(&bar);
  if (threadIdx.x < CORNER_BYTES / 16) {
    const int4 v = s[threadIdx.x];
    const unsigned one = 0x00010001u;
    out[threadIdx.x] = make_int4((int)__vadd2((unsigned)v.x, one),
                                 (int)__vadd2((unsigned)v.y, one),
                                 (int)__vadd2((unsigned)v.z, one),
                                 (int)__vadd2((unsigned)v.w, one));
  }
}

// out [8, 128] = A[slab] of A [4, 8, 128] int32: 8 blocks of one warp,
// block b row b of the slab. Each block walks its own steps (`steps`, 1 as
// the script's grid has one step); pl.when(program_id(0) == 0) copies at
// the first step of that sequential axis, so lane 0 starts the bulk load
// only where the block has a step 0 (steps > 0, known at run time) and arms
// the barrier for the row's bytes, else for 0 bytes, so the phase completes
// without a copy and the warp's wait never blocks. Every step stores what
// landed, which later steps would reuse. (Checking step == 0 inside the
// step loop instead kept the copy's start behind the loop's set-up.)
__global__ void __launch_bounds__(32)
caps_dma_in_when(const int32_t* __restrict__ A, int4* __restrict__ out,
                 int slab, int steps) {
  __shared__ __align__(128) int4 s[32];
  __shared__ __align__(8) uint64_t bar;
  const int lane = threadIdx.x;
  const int32_t* src = A + (size_t)(slab * 8 + blockIdx.x) * 128;
  if (lane == 0) {
    barrier_init(&bar);
    const bool step0 = steps > 0;
    expect_bytes(&bar, step0 ? ROW_BYTES : 0);
    if (step0) bulk_load(s, src, ROW_BYTES, &bar);
  }
  __syncwarp();
  wait_phase0(&bar);
  for (int step = 0; step < steps; ++step)
    out[blockIdx.x * 32 + lane] = s[lane];
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

// The map of A [4, 19, 16, 16] int16 seen as [76, 16, 16], box [19, 8, 8],
// encoded only when A's address differs from the last call's (the map
// holds the address, the shape and the strides, and only the address can
// change); the kernel takes it by value, so a launch queued with the last
// map keeps it.
int strided_corner_map(const void* A, CUtensorMap* tmap) {
  static std::mutex mu;
  static const void* last = nullptr;
  static CUtensorMap map;
  const std::lock_guard<std::mutex> lock(mu);
  if (A != last) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
    const cuuint64_t dims[3] = {16, 16, 4 * 19};
    const cuuint64_t strides[2] = {16 * 2, 16 * 16 * 2};  // bytes, dims 1, 2
    const cuuint32_t box[3] = {8, 8, 19};
    const cuuint32_t elem_strides[3] = {1, 1, 1};
    const CUresult rc = encode(
        &map, CU_TENSOR_MAP_DATA_TYPE_UINT16, 3, const_cast<void*>(A), dims,
        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (rc != CUDA_SUCCESS) {
      last = nullptr;
      return (int)cudaErrorInvalidValue;
    }
    last = A;
  }
  *tmap = map;
  return 0;
}

}  // namespace

int caps::bulk(int check, const void* in0, const void* in1, void* out,
               int arg, cudaStream_t s) {
  (void)in1;
  switch (check) {
    case MANUAL_DMA_DYNOFF:  // arg: the first row, 0..48
      if (arg < 0 || arg > 64 - 16) return (int)cudaErrorInvalidValue;
      caps_manual_dma<<<16, 32, 0, s>>>(static_cast<const int32_t*>(in0),
                                        static_cast<int32_t*>(out), arg);
      break;
    case DMA_STRIDED_3D: {  // arg: the slab, 0..3
      if (arg < 0 || arg > 3) return (int)cudaErrorInvalidValue;
      CUtensorMap tmap;
      const int rc = strided_corner_map(in0, &tmap);
      if (rc != 0) return rc;
      caps_dma_strided<<<1, 160, 0, s>>>(tmap, static_cast<int4*>(out), arg);
      break;
    }
    case DMA_IN_WHEN:  // arg: the slab, 0..3
      if (arg < 0 || arg > 3) return (int)cudaErrorInvalidValue;
      caps_dma_in_when<<<8, 32, 0, s>>>(static_cast<const int32_t*>(in0),
                                        static_cast<int4*>(out), arg, 1);
      break;
    default:
      return NOT_MINE;
  }
  return (int)cudaGetLastError();
}
