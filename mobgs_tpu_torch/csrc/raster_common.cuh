// Shared by the forward and backward tile compositors (raster_fwd.cu,
// raster_bwd.cu): the constants of the Pallas kernels and the per-pair
// arithmetic whose rounding decides a gate.
//
// The backward replays the forward and anchors its suffix sums on the
// forward's output, so both must keep and drop exactly the same (slot,
// pixel) pairs and stop at the same chunk. sigma, alpha and the chunk's
// transmittance product are therefore computed here once, rounded op by op
// in the plain PyTorch version's order: the _rn intrinsics are never
// contracted into FMAs, so the gates sigma >= 0 and alpha > 1/255 decide as
// they do there and in the other kernel.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace raster {

constexpr int TILE = 16;
constexpr int P = TILE * TILE;  // pixels per tile = threads per block
constexpr int CH_MAX = 128;     // largest chunk
constexpr int R = 8;            // record row: mx, my, a, b, c, o, o_sub, pad
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float TRANS_EPS = 1e-4f;

// sigma = 0.5 (a dx^2 + c dy^2) + b dx dy with dx = px - mx, dy = py - my.
__device__ __forceinline__ float splat_sigma(float px, float py, float mx,
                                             float my, float a, float b,
                                             float c, float& dx, float& dy) {
  dx = __fsub_rn(px, mx);
  dy = __fsub_rn(py, my);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(a, dx), dx),
                               __fmul_rn(__fmul_rn(c, dy), dy));
  return __fadd_rn(__fmul_rn(0.5f, quad), __fmul_rn(__fmul_rn(b, dx), dy));
}

// Unclamped alpha o e^-sigma; the caller clamps with fminf(ALPHA_MAX, .)
// and the backward also needs the raw value for its raw < 0.99 gate.
__device__ __forceinline__ float splat_raw_alpha(float opacity, float expneg) {
  return __fmul_rn(opacity, expneg);
}

// One step of the chunk's exclusive prefix product of (1 - alpha).
__device__ __forceinline__ float trans_step(float t, float alpha) {
  return __fmul_rn(t, __fsub_rn(1.f, alpha));
}

}  // namespace raster
