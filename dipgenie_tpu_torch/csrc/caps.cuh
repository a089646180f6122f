// The capability checks: the counterparts of scripts/tpu_caps_probe.py (K8)
// and scripts/tpu_caps_probe2.py (K9), one id each, in the scripts' order,
// which is also that of dipgenie_tpu_torch/ops/caps.py:NAMES.
//
// Each TPU check was one tiny Pallas call asking whether Mosaic lowers one
// primitive. Each kernel here asks the same of the Hopper primitive that
// stands for it, at the scripts' shapes. The checks move 2-125 KB each,
// 1-40 ns at 3.35 TB/s, and the products do at most 1.3 MFLOP: every one
// is bound by its launch, not by the card's bytes or operations.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace caps {

enum Check : int {
  // K8, scripts/tpu_caps_probe.py
  LANE_GATHER_TAA_GROUPED,
  LANE_GATHER_CROSS_VREG,
  SUBLANE_GATHER_8,
  SUBLANE_GATHER_16,
  ROLL_LANE,
  ROLL_SUBLANE,
  LANE_BCAST_COL,
  SUBLANE_BCAST_ROW,
  TILE_LANE_CONCAT,
  DYN_SLICE_ROW_BCAST,
  MANUAL_DMA_DYNOFF,
  SCALAR_PREFETCH_GRID,
  POPCOUNT,
  STRIDED_SLICE_LANE,
  RESHAPE_LANE_GROUPS,
  // K9, scripts/tpu_caps_probe2.py
  BATCHED_DOT_3D,
  BATCHED_DOT_BCAST_LHS,
  CONCAT3D_AX0,
  CONCAT3D_AX1,
  CONCAT3D_AX2,
  ROLL3D_AX1,
  ROLL3D_AX2,
  CONVERT_F32_I32_3D,
  IOTA_ONEHOT_BUILD,
  WHERE3D_IOTA_MASK,
  TRANSPOSE2D,
  DMA_STRIDED_3D,
  SWITCH_COMPUTE,
  DMA_IN_WHEN,
  DOT2D_F32,
  N_CHECKS
};

constexpr int NOT_MINE = -1;  // a family launcher's answer to another's id

// One launcher per family (caps_gather.cu, caps_layout.cu, caps_bulk.cu,
// caps_mma.cu): launches the check on `stream` and returns
// cudaGetLastError(), or NOT_MINE. `in1` is null for a check with one
// input; `arg` is the run-time offset of the bulk copies.
int gather(int check, const void* in0, const void* in1, void* out, int arg,
           cudaStream_t stream);
int layout(int check, const void* in0, const void* in1, void* out, int arg,
           cudaStream_t stream);
int bulk(int check, const void* in0, const void* in1, void* out, int arg,
         cudaStream_t stream);
int mma(int check, const void* in0, const void* in1, void* out, int arg,
        cudaStream_t stream);

}  // namespace caps

// The one C entry point of the checks (defined in caps_gather.cu).
extern "C" int dg_caps(int check, const void* in0, const void* in1,
                       void* out, int arg, cudaStream_t stream);
