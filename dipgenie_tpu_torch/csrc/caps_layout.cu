// Capability checks, the layout family: broadcasts, a tile, a reshape,
// concatenations, a masked select, a float-to-int conversion, a one-hot, a
// transpose, a branch chosen on the device, and a population count.
//
// Replaces these checks of scripts/tpu_caps_probe.py: mk_lane_bcast_col
// (:132), mk_sublane_bcast_row (:145), mk_tile_lane (:158), mk_popcount
// (:240), mk_reshape_lane_groups (:265); and of scripts/tpu_caps_probe2.py:
// mk_concat3d_ax0 (:84), mk_concat3d_ax1 (:97), mk_concat3d_ax2 (:110),
// mk_convert_f32_i32_3d (:147), mk_iota3d_onehot (:159), mk_where3d (:176),
// mk_transpose2d (:190), mk_switch_compute (:237).
//
// What bounds them on the H100: each moves 2-40 KB (1-12 ns at 3.35 TB/s)
// and does at most one operation per element; the launch costs
// microseconds. On the TPU these probed whether Mosaic could relayout a
// vreg (lanes against sublanes); on Hopper a layout is an index map, so the
// kernels are one thread per output element with coalesced stores, and
// what they probe is the instruction or memory path named at each: one
// load per row broadcast from shared memory, a padded shared-memory tile
// for the transpose, __float2int_rz, __popc, a branch read from device
// memory inside the kernel (lax.switch clamps its index, so does this).
#include "caps.cuh"

namespace {

constexpr int R1 = 19;

// [16, 1] -> [16, 256]: one load per row, broadcast from shared memory.
__global__ void __launch_bounds__(256)
caps_bcast_col(const int32_t* __restrict__ A, int32_t* __restrict__ out) {
  __shared__ int32_t v;
  if (threadIdx.x == 0) v = A[blockIdx.x];
  __syncthreads();
  out[blockIdx.x * 256 + threadIdx.x] = v;
}

// [1, 256] -> [16, 256]: one load per column, stored to every row.
__global__ void __launch_bounds__(256)
caps_bcast_row(const int32_t* __restrict__ A, int32_t* __restrict__ out) {
  const int32_t v = A[threadIdx.x];
#pragma unroll
  for (int r = 0; r < 16; ++r) out[r * 256 + threadIdx.x] = v;
}

// [16, 16] -> [16, 304]: np.tile(A, (1, 19)); one load per element.
__global__ void __launch_bounds__(256)
caps_tile_lanes(const int32_t* __restrict__ A, int32_t* __restrict__ out) {
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
  const int32_t v = A[threadIdx.x];
  for (int k = 0; k < 19; ++k) out[r * 304 + k * 16 + c] = v;
}

// A reshape keeps the bytes: a copy of n 16-byte words.
__global__ void __launch_bounds__(256)
caps_copy16(const int4* __restrict__ A, int4* __restrict__ out, int n) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i < n) out[i] = A[i];
}

// [19, 16, 16]: out[0] = -7, out[r] = A[r - 1].
__global__ void __launch_bounds__(256)
caps_concat_ax0(const int32_t* __restrict__ A, int32_t* __restrict__ out) {
  const int o = blockIdx.x * 256 + threadIdx.x;
  out[o] = blockIdx.x == 0 ? -7 : A[o - 256];
}

// [19, 16, 16] -> [A, A + 1] along axis 2 (`minor`, [19, 16, 32]) or
// axis 1 ([19, 32, 16]); one thread per output element.
__global__ void __launch_bounds__(256)
caps_concat_plus(const int32_t* __restrict__ A, int32_t* __restrict__ out,
                 bool minor) {
  const int o = blockIdx.x * 256 + threadIdx.x;
  const int r = o >> 9, rest = o & 511;
  int i, k, second;
  if (minor) {
    i = rest >> 5;
    k = rest & 15;
    second = (rest >> 4) & 1;
  } else {
    i = (rest >> 4) & 15;
    k = rest & 15;
    second = rest >> 8;
  }
  out[o] = A[(r << 8) | (i << 4) | k] + second;
}

// [19, 16, 16]: where(row < 8, A, -1).
__global__ void __launch_bounds__(256)
caps_where_rows(const int32_t* __restrict__ A, int32_t* __restrict__ out) {
  const int o = blockIdx.x * 256 + threadIdx.x;
  out[o] = (threadIdx.x >> 4) < 8 ? A[o] : -1;
}

// f32 -> i32 toward zero, times 2.
__global__ void __launch_bounds__(256)
caps_convert(const float* __restrict__ A, int32_t* __restrict__ out) {
  const int o = blockIdx.x * 256 + threadIdx.x;
  out[o] = __float2int_rz(A[o]) * 2;
}

// sel [16, 1] -> one-hot [16, 32] f32.
__global__ void __launch_bounds__(512)
caps_onehot(const int32_t* __restrict__ sel, float* __restrict__ out) {
  const int i = threadIdx.x >> 5, c = threadIdx.x & 31;
  out[threadIdx.x] = c == sel[i] ? 1.0f : 0.0f;
}

// [304, 16] f32 -> [16, 304]: block b moves rows 16 b .. 16 b + 15 through
// a [16][17] shared tile (the pad keeps the column reads off one bank).
__global__ void __launch_bounds__(256)
caps_transpose(const float* __restrict__ A, float* __restrict__ out) {
  __shared__ float tile[16][17];
  const int r = threadIdx.x >> 4, c = threadIdx.x & 15;
  tile[r][c] = A[(blockIdx.x * 16 + r) * 16 + c];
  __syncthreads();
  out[r * 304 + blockIdx.x * 16 + c] = tile[c][r];
}

// [19, 16, 16]: branch b[0] (clamped to 0..2) of [x + 1, x[:, :8, :8] *= 2,
// x - 3], chosen by every thread from device memory.
__global__ void __launch_bounds__(256)
caps_switch(const int32_t* __restrict__ b, const int32_t* __restrict__ A,
            int32_t* __restrict__ out) {
  const int o = blockIdx.x * 256 + threadIdx.x;
  const int branch = min(max(b[0], 0), 2);
  int32_t v = A[o];
  if (branch == 0) {
    v += 1;
  } else if (branch == 1) {
    if ((threadIdx.x >> 4) < 8 && (threadIdx.x & 15) < 8) v *= 2;
  } else {
    v -= 3;
  }
  out[o] = v;
}

// Population count of each 32-bit word.
__global__ void __launch_bounds__(256)
caps_popcount(const uint32_t* __restrict__ A, int32_t* __restrict__ out) {
  const int o = blockIdx.x * 256 + threadIdx.x;
  out[o] = __popc(A[o]);
}

}  // namespace

int caps::layout(int check, const void* in0, const void* in1, void* out,
                 int arg, cudaStream_t s) {
  (void)arg;
  const auto* a = static_cast<const int32_t*>(in0);
  auto* o = static_cast<int32_t*>(out);
  switch (check) {
    case LANE_BCAST_COL:
      caps_bcast_col<<<16, 256, 0, s>>>(a, o);
      break;
    case SUBLANE_BCAST_ROW:
      caps_bcast_row<<<1, 256, 0, s>>>(a, o);
      break;
    case TILE_LANE_CONCAT:
      caps_tile_lanes<<<1, 256, 0, s>>>(a, o);
      break;
    case RESHAPE_LANE_GROUPS:  // [16, 304] int32: 1,216 16-byte words
      caps_copy16<<<5, 256, 0, s>>>(static_cast<const int4*>(in0),
                                    static_cast<int4*>(out), 16 * 304 / 4);
      break;
    case CONCAT3D_AX0:
      caps_concat_ax0<<<R1, 256, 0, s>>>(a, o);
      break;
    case CONCAT3D_AX1:
      caps_concat_plus<<<2 * R1, 256, 0, s>>>(a, o, false);
      break;
    case CONCAT3D_AX2:
      caps_concat_plus<<<2 * R1, 256, 0, s>>>(a, o, true);
      break;
    case WHERE3D_IOTA_MASK:
      caps_where_rows<<<R1, 256, 0, s>>>(a, o);
      break;
    case CONVERT_F32_I32_3D:
      caps_convert<<<R1, 256, 0, s>>>(static_cast<const float*>(in0), o);
      break;
    case IOTA_ONEHOT_BUILD:
      caps_onehot<<<1, 512, 0, s>>>(a, static_cast<float*>(out));
      break;
    case TRANSPOSE2D:
      caps_transpose<<<R1, 256, 0, s>>>(static_cast<const float*>(in0),
                                        static_cast<float*>(out));
      break;
    case SWITCH_COMPUTE:  // in0 is b, in1 is A
      caps_switch<<<R1, 256, 0, s>>>(a, static_cast<const int32_t*>(in1), o);
      break;
    case POPCOUNT:  // the wrapper passes the uint32 words as their int32 view
      caps_popcount<<<16, 256, 0, s>>>(static_cast<const uint32_t*>(in0), o);
      break;
    default:
      return NOT_MINE;
  }
  return (int)cudaGetLastError();
}
