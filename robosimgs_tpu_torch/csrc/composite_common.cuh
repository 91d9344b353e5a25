// What csrc/composite_fwd.cu and csrc/composite_bwd.cu must compute bit
// for bit alike: the per-(pixel, splat) alpha test and the grouping of the
// log-transmittance sum.
//
// The backward rebuilds each splat's transmittance from the forward's
// log_t_final by taking back, batch by batch, the sum the forward added.
// Both kernels sum log1p(-alpha) of the kept splats of a BK-slot batch in
// slot order, starting from 0, and add the batch's sum to the carried
// log-T once (the Pallas kernel's structure), so the backward recomputes
// every batch sum and every partial sum inside it with the same bits; the
// only rounding left between the two is one subtraction per batch.
// Saturated pixels carry log T near -350, where a per-splat subtraction
// chain from log_t_final would lose ~1e-3 of the front splats'
// transmittance. The roundings of q and of op * e^-q are pinned with
// intrinsics, so no FMA contraction can make the two kernels' alphas
// differ.

#pragma once

#include <stdint.h>

namespace composite {

constexpr int BK = 128;        // splats per staged batch (the unit of nblk)
constexpr int GEOM_ROWS = 7;   // mx, my, conic a/b/c, opacity, depth
constexpr int FEAT_ROWS = 8;

struct SplatAlpha {
  float alpha;   // min(alpha_clamp, raw); meaningful where keep
  float raw;     // opacity * e^-q, before the clamp
  float dx, dy;  // pixel - mean
  bool keep;     // alpha >= alpha_min, q >= 0, within the depth limit
};

// Splat j of the staged batch sg (rows mx, my, conic a/b/c, opacity,
// depth) at pixel (px, py): q = .5 (a dx^2 + c dy^2) + b dx dy.
__device__ __forceinline__ SplatAlpha splat_alpha(
    const float (*sg)[BK], int j, float px, float py, bool has_dlim,
    float lim, float alpha_clamp, float alpha_min) {
  SplatAlpha s;
  s.dx = __fsub_rn(px, sg[0][j]);
  s.dy = __fsub_rn(py, sg[1][j]);
  const float q = __fmaf_rn(
      0.5f,
      __fmaf_rn(sg[2][j], __fmul_rn(s.dx, s.dx),
                __fmul_rn(sg[4][j], __fmul_rn(s.dy, s.dy))),
      __fmul_rn(sg[3][j], __fmul_rn(s.dx, s.dy)));
  s.raw = __fmul_rn(sg[5][j], expf(-q));
  s.alpha = fminf(alpha_clamp, s.raw);
  s.keep = s.alpha >= alpha_min && q >= 0.f && (!has_dlim || sg[6][j] <= lim);
  return s;
}

}  // namespace composite
