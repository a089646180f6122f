// Constants shared by the pair-DP kernels. The values mirror
// dipgenie_tpu/ops/diploid_pallas.py (NEG, REACH_T, PAD_SC, CHUNK).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dg {

constexpr int CHUNK = 256;            // pairs per plan chunk
constexpr int NEG = -(1 << 19);       // unreachable state
constexpr int REACH_T = -(1 << 18);   // values above this are reachable
constexpr int PAD_SC = -(1 << 22);    // score of padded pair lanes

}  // namespace dg

// Text of a CUDA error code, for the Python wrappers' messages.
extern "C" const char* dg_error_string(int code);
