// Capability checks, the gather family: lane and sublane gathers, rolls, a
// row picked by a value read inside the kernel, a grid whose blocks load
// their own indices, and a strided slice.
//
// Replaces these checks of scripts/tpu_caps_probe.py: mk_lane_gather_taa
// (:46), mk_lane_gather_cross (:63), mk_sublane_gather (:78),
// mk_sublane_gather16 (:93), mk_roll_lane (:108), mk_roll_sublane (:120),
// mk_dyn_slice_row (:171), mk_scalar_prefetch (:215), mk_strided_slice
// (:252); and of scripts/tpu_caps_probe2.py: mk_roll3d_ax1 (:123),
// mk_roll3d_ax2 (:135).
//
// What bounds them on the H100: each moves 8-48 KB (2-15 ns at 3.35 TB/s);
// the launch costs microseconds. The primitives probed:
//   * a gather inside a 16-lane group (the TPU's in-vreg lane gather) is
//     __shfl_sync with width 16: a warp holds 32 lanes of a row;
//   * a gather anywhere in a 256-lane row, and a gather along the columns
//     (the TPU's sublanes), stage the rows in shared memory and index it
//     (the column gather a slab of 256 / ROWS columns a block);
//   * pltpu.roll along lanes is index arithmetic over a slab staged in
//     shared memory; inside a 16-wide segment it is a shuffle; along
//     sublanes (whole rows) it is a copy with no staging: each thread
//     moves one 16-byte int4 from its source row (one block staging the
//     24 KB through shared memory measured 3.6x slower on the H100);
//   * the row index of dyn_slice_row_bcast and the per-block selection of
//     scalar_prefetch_grid are read from device memory by the kernel
//     itself: no host read, no synchronisation ("a block loads its own
//     indices").
// Indices are masked to their range (the checks' contract keeps them in
// it), so a bad index reads a wrong element, never outside the tensor.
#include "caps.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

// [16, 256]: out[r, j] = A[r, idx[r, j]], idx inside j's 16-lane group.
// One block per row, a warp per 32 lanes.
__global__ void __launch_bounds__(256)
caps_lane_gather_grouped(const int32_t* __restrict__ A,
                         const int32_t* __restrict__ idx,
                         int32_t* __restrict__ out) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  const int32_t a = A[i];
  out[i] = __shfl_sync(FULL, a, idx[i] & 15, 16);
}

// [16, 256]: out[r, j] = A[r, idx[r, j]], idx anywhere in the row.
__global__ void __launch_bounds__(256)
caps_lane_gather_cross(const int32_t* __restrict__ A,
                       const int32_t* __restrict__ idx,
                       int32_t* __restrict__ out) {
  __shared__ int32_t row[256];
  const int i = blockIdx.x * 256 + threadIdx.x;
  row[threadIdx.x] = A[i];
  __syncthreads();
  out[i] = row[idx[i] & 255];
}

// [ROWS, 128]: out[i, j] = A[idx[i, j], j]. Blocks of 256 threads, block
// b owning the COLS = 256 / ROWS columns COLS b .. COLS (b + 1) - 1 (4
// blocks at 8 rows, 8 at 16), a thread an element: each thread loads its
// element of A into the block's [ROWS, COLS] slab and its index, both
// before the barrier, so that the two loads are in flight together; then
// it picks its element from the slab. The one block of 1,024 threads this
// replaces staged all of A on one SM and loaded the indices only after its
// barrier: 1.433 / 1.818 us of device time at 8 / 16 rows on an H100 80GB
// HBM3 at 700 W (PERF.md section 6), where 16, 32 and 64 columns a block
// took 1.06 / 1.04 / 1.08 us at 8 rows and 1.05 / 1.09 / 1.20 at 16.
template <int ROWS>
__global__ void __launch_bounds__(256)
caps_sublane_gather(const int32_t* __restrict__ A,
                    const int32_t* __restrict__ idx,
                    int32_t* __restrict__ out) {
  constexpr int COLS = 256 / ROWS;
  __shared__ int32_t s[ROWS][COLS];
  const int r = threadIdx.x / COLS, c = threadIdx.x % COLS;
  const int i = r * 128 + blockIdx.x * COLS + c;
  const int32_t a = A[i];
  const int k = idx[i] & (ROWS - 1);
  s[r][c] = a;
  __syncthreads();
  out[i] = s[k][c];
}

// np.roll along the middle axis of A seen as [gridDim.x, n, inner]:
// out[o, j, k] = A[o, (j - shift) mod n, k]. One block per o, its slab
// staged in (dynamic) shared memory.
__global__ void caps_roll_smem(const int32_t* __restrict__ A,
                               int32_t* __restrict__ out, int n, int inner,
                               int shift) {
  extern __shared__ int32_t slab[];
  const int m = n * inner;
  const size_t base = (size_t)blockIdx.x * m;
  for (int i = threadIdx.x; i < m; i += blockDim.x) slab[i] = A[base + i];
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int j = i / inner, k = i - j * inner;
    out[base + i] = slab[((j - shift) % n + n) % n * inner + k];
  }
}

// np.roll of whole rows: A is [n, 4 * vec] int32, n rows of vec int4;
// out row j = A row (j - shift) mod n (0 <= shift < n). One 16-byte int4
// per thread, no shared memory and no barrier: a warp moves 512 contiguous
// bytes of one row (four 128-byte lines), and the grid spreads over SMs.
__global__ void __launch_bounds__(128)
caps_roll_rows(const int4* __restrict__ A, int4* __restrict__ out, int n,
               int vec, int shift) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * vec) return;
  const int j = i / vec, c = i - j * vec;
  const int src = j >= shift ? j - shift : j - shift + n;
  out[i] = A[src * vec + c];
}

// np.roll of a [16, 16] slab per block (A is [gridDim.x, 16, 16]) by
// `shift` along axis 2 (`minor`) or axis 1: a 16-lane shuffle segment runs
// along the rolled axis, and lane l takes the value of lane l - shift.
__global__ void __launch_bounds__(256)
caps_roll_shfl(const int32_t* __restrict__ A, int32_t* __restrict__ out,
               bool minor, int shift) {
  const int lane = threadIdx.x & 15, other = threadIdx.x >> 4;
  const int off = minor ? other * 16 + lane : lane * 16 + other;
  const size_t i = (size_t)blockIdx.x * 256 + off;
  const int32_t a = A[i];
  out[i] = __shfl_sync(FULL, a, (lane - shift) & 15, 16);
}

// [16, 256]: every row of out is A[A[0, 0] mod 16] (a floor modulo). The
// index is read here, by every thread, from device memory.
__global__ void __launch_bounds__(256)
caps_dyn_slice_row(const int32_t* __restrict__ A, int32_t* __restrict__ out) {
  const int row = ((A[0] % 16) + 16) % 16;
  out[blockIdx.x * 256 + threadIdx.x] = A[row * 256 + threadIdx.x];
}

// [8, 8, 128]: out[t] = A[sel[t]]; block t reads sel[t] itself and copies
// the [8, 128] block with 16-byte loads.
__global__ void __launch_bounds__(256)
caps_select_blocks(const int32_t* __restrict__ sel,
                   const int4* __restrict__ A, int4* __restrict__ out) {
  const int src = sel[blockIdx.x] & 7;
  out[blockIdx.x * 256 + threadIdx.x] = A[src * 256 + threadIdx.x];
}

// [16, 304] -> [16, 19]: out[r, c] = A[r, 3 + 16 c].
__global__ void __launch_bounds__(304)
caps_strided_slice(const int32_t* __restrict__ A, int32_t* __restrict__ out) {
  const int r = threadIdx.x / 19, c = threadIdx.x % 19;
  out[threadIdx.x] = A[r * 304 + 3 + 16 * c];
}

}  // namespace

int caps::gather(int check, const void* in0, const void* in1, void* out,
                 int arg, cudaStream_t s) {
  (void)arg;
  const auto* a = static_cast<const int32_t*>(in0);
  const auto* b = static_cast<const int32_t*>(in1);
  auto* o = static_cast<int32_t*>(out);
  switch (check) {
    case LANE_GATHER_TAA_GROUPED:
      caps_lane_gather_grouped<<<16, 256, 0, s>>>(a, b, o);
      break;
    case LANE_GATHER_CROSS_VREG:
      caps_lane_gather_cross<<<16, 256, 0, s>>>(a, b, o);
      break;
    case SUBLANE_GATHER_8:  // 4 blocks of 32 columns
      caps_sublane_gather<8><<<8 * 128 / 256, 256, 0, s>>>(a, b, o);
      break;
    case SUBLANE_GATHER_16:  // 8 blocks of 16 columns
      caps_sublane_gather<16><<<16 * 128 / 256, 256, 0, s>>>(a, b, o);
      break;
    case ROLL_LANE:  // [16, 256], by 16 along axis 1
      caps_roll_smem<<<16, 256, 256 * 4, s>>>(a, o, 256, 1, 16);
      break;
    case ROLL_SUBLANE:  // [24, 256], by 1 along axis 0: 24 x 64 int4
      caps_roll_rows<<<24 * 64 / 128, 128, 0, s>>>(
          static_cast<const int4*>(in0), static_cast<int4*>(out), 24, 64, 1);
      break;
    case ROLL3D_AX1:  // [19, 16, 16], by 4
      caps_roll_shfl<<<19, 256, 0, s>>>(a, o, false, 4);
      break;
    case ROLL3D_AX2:
      caps_roll_shfl<<<19, 256, 0, s>>>(a, o, true, 4);
      break;
    case DYN_SLICE_ROW_BCAST:
      caps_dyn_slice_row<<<16, 256, 0, s>>>(a, o);
      break;
    case SCALAR_PREFETCH_GRID:  // in0 is sel, in1 is A
      caps_select_blocks<<<8, 256, 0, s>>>(
          a, static_cast<const int4*>(in1), static_cast<int4*>(out));
      break;
    case STRIDED_SLICE_LANE:
      caps_strided_slice<<<1, 304, 0, s>>>(a, o);
      break;
    default:
      return NOT_MINE;
  }
  return (int)cudaGetLastError();
}

extern "C" int dg_caps(int check, const void* in0, const void* in1,
                       void* out, int arg, cudaStream_t stream) {
  using Family = int (*)(int, const void*, const void*, void*, int,
                         cudaStream_t);
  const Family families[] = {caps::gather, caps::layout, caps::bulk,
                             caps::mma};
  for (Family family : families) {
    const int rc = family(check, in0, in1, out, arg, stream);
    if (rc != caps::NOT_MINE) return rc;
  }
  return (int)cudaErrorInvalidValue;
}
