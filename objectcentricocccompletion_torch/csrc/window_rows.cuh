// Constants shared by every window-attention kernel: log2(e), and the masked
// logit in the log2 domain the kernels' softmax works in.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace window_rows {

constexpr float kLog2e = 1.4426950408889634f;
// The JAX package's masked logit (-1e9), in the log2 domain the kernels use.
constexpr float kMaskedLogit2 = -1e9f * kLog2e;

}  // namespace window_rows
