// activation.cuh: the update stage's activations, shared by the update
// kernels (update_mlp.cu, aggregate_fused.cu, and fused_bwd's dy kernel
// through fused_update.cuh).
// The codes are kernels/update_mlp.py's ACTS.

#pragma once

#include <cuda_runtime.h>

namespace activation {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2 };

constexpr float SQRT_2_OVER_PI = 0.7978845608028654f;
constexpr float GELU_C = 0.044715f;

// jax.nn.gelu's default: the tanh form
__device__ inline float act_apply(float y, int act) {
  if (act == ACT_RELU) return fmaxf(y, 0.f);
  if (act == ACT_GELU) {
    const float u = SQRT_2_OVER_PI * (y + GELU_C * y * y * y);
    return y * (0.5f * (1.f + tanhf(u)));
  }
  return y;
}

// With u the tanh's argument, 0.5 (1 + tanh u) = sigmoid(2u) and
// 1 - tanh(u)^2 = 4 sigmoid(2u) sigmoid(-2u); this form keeps its accuracy
// where tanh saturates, which 1 - tanh^2 does not.
__device__ inline float act_grad(float y, int act) {
  if (act == ACT_RELU) return y > 0.f ? 1.f : 0.f;
  if (act == ACT_GELU) {
    const float u2 = 2.f * SQRT_2_OVER_PI * (y + GELU_C * y * y * y);
    const float sg = 1.f / (1.f + expf(-u2));
    const float sg_neg = 1.f / (1.f + expf(u2));
    return sg + 2.f * y * sg * sg_neg * SQRT_2_OVER_PI
           * (1.f + 3.f * GELU_C * y * y);
  }
  return 1.f;
}

}  // namespace activation
