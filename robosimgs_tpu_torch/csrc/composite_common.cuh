// What csrc/composite_fwd.cu and csrc/composite_bwd.cu share: the
// per-(pixel, splat) alpha test and the grouping of the log-transmittance
// sum, which the two must compute bit for bit alike, and the staging of a
// splat batch into shared memory.
//
// The backward rebuilds each splat's transmittance from the forward's
// log_t_final by taking back, batch by batch, the sum the forward added.
// Both kernels sum log1p(-alpha) of the kept splats of a BK-slot batch in
// slot order, starting from 0, and add the batch's sum to the carried
// log-T once (the Pallas kernel's structure). The forward also stores its
// running batch sum at the end of every LT_GROUP-slot group (the residual
// log_t_groups), so the backward starts each group's walk from the
// forward's own partial sum and takes back the forward's own batch sum:
// the only rounding left between the two is one subtraction per batch.
// Saturated pixels carry log T near -350, where a per-splat subtraction
// chain from log_t_final would lose ~1e-3 of the front splats'
// transmittance. The roundings of q, of op * e^-q and of the running sum
// are pinned with intrinsics, so no FMA contraction can make the two
// kernels' numbers differ.

#pragma once

#include <stdint.h>

namespace composite {

constexpr int BK = 128;        // splats per staged batch (the unit of nblk)
constexpr int LT_GROUP = 16;   // slots per log_t_groups entry
constexpr int GROUPS_PER_BATCH = BK / LT_GROUP;
constexpr int GEOM_ROWS = 7;   // mx, my, conic a/b/c, opacity, depth
constexpr int FEAT_ROWS = 8;

struct SplatAlpha {
  float alpha;   // min(alpha_clamp, raw); meaningful where keep
  float raw;     // opacity * e^-q, before the clamp
  bool keep;     // alpha >= alpha_min, q >= 0, within the depth limit
};

__device__ __forceinline__ float lane4(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// Row r of splats j..j+3 of a staged batch (j % 4 == 0): one 16-byte
// shared-memory load, broadcast to the warp.
__device__ __forceinline__ float4 row4(const float (*rows)[BK], int r,
                                       int j) {
  return *reinterpret_cast<const float4*>(&rows[r][j]);
}

// Splats j..j+3 of the staged batch sg (rows mx, my, conic a/b/c,
// opacity, depth) at pixel (px, py): q = .5 (a dx^2 + c dy^2) + b dx dy.
// Writes e[0..3].
__device__ __forceinline__ void splat_alpha4(
    const float (*sg)[BK], int j, float px, float py, bool has_dlim,
    float lim, float alpha_clamp, float alpha_min, SplatAlpha* e) {
  const float4 mx = row4(sg, 0, j), my = row4(sg, 1, j);
  const float4 ca = row4(sg, 2, j), cb = row4(sg, 3, j), cc = row4(sg, 4, j);
  const float4 op = row4(sg, 5, j);
  const float4 dp = has_dlim ? row4(sg, 6, j) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float dx = __fsub_rn(px, lane4(mx, u));
    const float dy = __fsub_rn(py, lane4(my, u));
    const float q = __fmaf_rn(
        0.5f,
        __fmaf_rn(lane4(ca, u), __fmul_rn(dx, dx),
                  __fmul_rn(lane4(cc, u), __fmul_rn(dy, dy))),
        __fmul_rn(lane4(cb, u), __fmul_rn(dx, dy)));
    e[u].raw = __fmul_rn(lane4(op, u), expf(-q));
    e[u].alpha = fminf(alpha_clamp, e[u].raw);
    e[u].keep = e[u].alpha >= alpha_min && q >= 0.f &&
                (!has_dlim || lane4(dp, u) <= lim);
  }
}

// One step of the running log-T sum: s + log1p(-alpha), rounded once.
// alpha = 0 (a pair not kept) adds -0 and leaves s's bits as they were.
__device__ __forceinline__ float log_t_add(float s, float alpha) {
  return __fadd_rn(s, log1pf(-alpha));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most `pending` of this thread's committed groups are in
// flight; a __syncthreads() after it makes every thread's copies visible.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
}

// Issues (does not commit) the asynchronous copies of slots [off, off +
// BK) of one tile's geom rows 0..geom_rows-1 and feat rows 0..7 (rows K
// floats apart, K a multiple of BK, the bases 16-byte aligned: the
// wrapper checks) into sg/sf, 16 bytes a copy. Slots past the tile's
// count are copied too (they lie inside the capacity K) and never read.
__device__ __forceinline__ void stage_batch(float (*sg)[BK], float (*sf)[BK],
                                            const float* g, const float* f,
                                            int K, int off, int geom_rows) {
  constexpr int CHUNKS = BK / 4;
  const int rows = geom_rows + FEAT_ROWS;
  for (int i = threadIdx.x; i < rows * CHUNKS; i += blockDim.x) {
    const int r = i / CHUNKS;
    const int j = (i - r * CHUNKS) * 4;
    if (r < geom_rows) {
      cp_async16(&sg[r][j], g + static_cast<size_t>(r) * K + off + j);
    } else {
      cp_async16(&sf[r - geom_rows][j],
                 f + static_cast<size_t>(r - geom_rows) * K + off + j);
    }
  }
}

}  // namespace composite
