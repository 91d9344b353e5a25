// Per-tile back-to-front compositing backward for Hopper (sm_90a).
//
// Replaces robosimgs_tpu/render/pallas_kernels.py::_bwd_kernel (entry
// composite_bwd_pallas). Built by robosimgs_tpu_torch/render/_build.py
// with nvcc into a shared library with a plain C interface; called
// through ctypes by robosimgs_tpu_torch/render/kernels.py::composite_bwd,
// the backward of the autograd function `Composite`.
//
// Inputs: the forward's inputs (geom/feat (T,8,K), counts (T,), dlim
// (T,P,1)), the cotangent gout (T,8,P) of its output, and its residuals
// log_t_final (T,P,1), log_t_groups (T,K/LT_GROUP,P) and nblk (T,).
// Outputs dgeom/dfeat (T,8,K), every (row, slot) written exactly once, no
// atomics: the per-Gaussian sum is the caller's (the transpose of the
// binner's gather).
//
// Two kernels. Tiles of up to 16x16 pixels in whole warps run
// composite_bwd_kernel: one 256-thread block per tile, one thread per
// pixel. Every other tile of up to 32x32 pixels (P <= 1024, P not a
// multiple of 32 included) runs composite_bwd_split_kernel, described
// below it.
//
// composite_bwd_kernel walks the tile's processed 128-splat batches from
// the last to the first, each staged in shared memory (geom rows 0..6,
// feat rows 0..7, 7.5 KB) by cp.async while the batch behind it is swept,
// and each batch in LT_GROUP-splat groups from the last to the first. The
// log-T entering the batch is the carried log-T minus the batch's sum,
// and a group starts from the forward's partial sum at its start: both
// read from log_t_groups, so each (pixel, splat) alpha is evaluated once.
// For a group a thread walks it front to back from that partial sum,
// keeping the group's alphas and log T_k in registers, then back to front
// carrying the suffix S = sum_{j>k} gamma_j w_j (gamma = gout . feat).
// Transmittance is never rebuilt by dividing a linear T (saturated pixels
// sit near log T = -350, where linear T is 0 in f32) nor by a per-splat
// subtraction chain from log_t_final.
// Per splat and pixel (zero through the 0.99 clamp, the 1/255 cutoff and
// the T (1 - alpha) >= t_min gate, exactly as the Pallas kernel):
//   w = alpha T_k m,  dL/dalpha = gamma T_k m - S / (1 - alpha),
//   dq = -alpha dL/dalpha where alpha is unclamped,
//   dmx = -dq (a dx + b dy), dmy = -dq (c dy + b dx), d conic = dq
//   (dx^2/2, dx dy, dy^2/2), d opacity = -sum dq / op, dfeat = gout w,
//   absgrad rows 7 = sum |dmx|, sum |dmy| per pixel.
// The 16 per-pixel values are summed over the tile's pixels: within a
// warp by a transposing butterfly (16 shuffles instead of 5 x 16: at each
// level a lane keeps half of the values and trades the other half), then
// across the 8 warps in order through padded (bank-conflict-free) dynamic
// shared memory, once per group (8.5 KB beside the 15 KB double-buffered
// batch).
//
// Two skips, each exact (the outputs are those of the full sweep):
// - A warp walks back only the slots that one of its pixels keeps (a
//   mask from its front-to-back pass); a slot that no pixel keeps adds 0.
// - A warp whose every pixel enters a group with log T below
//   log(t_min) - SKIP_MARGIN skips the group, alphas included. Log T only
//   falls along the splats, so each splat from there on has its gate
//   false (T_k (1 - alpha) < t_min) and the suffix S is still 0: every
//   value such a pixel adds is 0. The margin covers expf's error and the
//   one rounding per batch by which the rebuilt log T may rise at a
//   batch boundary: an ulp of a batch sum, below 6e-5 for 128 splats at
//   the 0.99 clamp, so 1e-2 covers 40 batches (K = 5120).
// Within a walked slot or group the lanes do not diverge: a pixel that
// does not keep a splat takes it with alpha = 0, which adds +-0 and
// leaves its running sums' bits as they were.
//
// Bound on this card: per evaluated (pixel, splat) pair the forward's
// ~17 FP32 operations (the alpha test), ~8 more per kept pair (the
// transmittance and the gate) and ~66 more per pair that carries weight
// (gamma's 8 FMAs, the 14 products and their sums over the tile),
// against 64 B of geom/feat per splat shared by the tile's pixels, 32 B
// of gout per pixel, 4 B of log_t_groups per pixel and 16 processed
// slots and 64 B of output per slot. At 16x16 and K = 384 the count says
// operations; at 32x32 and K = 14,464 the 64 B written per slot, most of
// them zeros past the processed batches, say bytes. Neither kernel is
// near its bound: a group step costs the same instructions whether one
// pixel of a warp keeps a slot or all 32 do, and a tile's batches form
// one chain of group steps (PERF.md).
//
// Not yet done: TMA staging, tensor-core forms of the sums over pixels.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "composite_common.cuh"

namespace {

namespace cg = cooperative_groups;

using composite::BK;
using composite::FEAT_ROWS;
using composite::GEOM_ROWS;
using composite::GROUPS_PER_BATCH;

constexpr int GROUP = composite::LT_GROUP;   // splats per register group
constexpr int MIN_BLOCKS = 2;                // resident blocks per SM
constexpr int NV = 16;         // per-pixel values summed over the tile
constexpr int THREADS = 256;   // threads per block, one-pixel kernel
constexpr int PART_STRIDE = GROUP + 1;   // pads the partials off one bank
constexpr float SKIP_MARGIN = 1e-2f;     // in log T
constexpr int MAX_DEVICES = 64;          // cards the launcher tracks
static_assert(GROUP <= 32 && GROUP % 4 == 0, "GROUP");

// The split kernel: LARGE_THREADS threads a block, LARGE_PIX pixels a
// thread (LARGE_THREADS * LARGE_PIX = 1024, the largest tile), and as
// many resident blocks per SM as 128 registers a thread allow (512 x 2
// ran the 32x32 shapes 1.6-2.0x faster than 256 x 4 on the card,
// PERF.md).
constexpr int LARGE_THREADS = 512;
constexpr int LARGE_PIX = 1024 / LARGE_THREADS;
constexpr int LARGE_MIN_BLOCKS = 512 / LARGE_THREADS;
constexpr int LARGE_WARPS = LARGE_THREADS / 32;
constexpr int BATCH_STRIDE = BK + 1;   // pads a batch's partials off one bank
constexpr int MAX_SPLITS = 8;          // blocks a tile (the portable cluster)
static_assert(LARGE_THREADS * LARGE_PIX == 1024 && LARGE_MIN_BLOCKS >= 1,
              "LARGE_THREADS");

// Values: 0 dmx, 1 dmy, 2 d conic a, 3 d conic b, 4 d conic c,
// 5 sum dq (-> d opacity), 6 |dmx|, 7 |dmy|, 8..15 dfeat rows 0..7.

// Output row -> value index (-1: written as zero).
__device__ __forceinline__ int value_of_row(int r, int absgrad) {
  if (r < 6) return r;
  if (r == 6) return -1;
  if (r == 7) return absgrad ? 6 : -1;
  if (r < 15) return r;
  return absgrad ? 7 : 15;
}

// Transposing butterfly over a full warp: afterwards lanes L and L^1 both
// hold the warp's sum of value vi(L), vi(L) = bits 4..1 of L, and the sum
// is in v[0].
__device__ __forceinline__ void warp_reduce_transpose(float (&v)[NV],
                                                      int lane) {
  const unsigned full = 0xffffffffu;
  {
    const bool up = lane & 16;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float send = up ? v[i] : v[i + 8];
      const float keep = up ? v[i + 8] : v[i];
      v[i] = keep + __shfl_xor_sync(full, send, 16);
    }
  }
  {
    const bool up = lane & 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float send = up ? v[i] : v[i + 4];
      const float keep = up ? v[i + 4] : v[i];
      v[i] = keep + __shfl_xor_sync(full, send, 8);
    }
  }
  {
    const bool up = lane & 4;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float send = up ? v[i] : v[i + 2];
      const float keep = up ? v[i + 2] : v[i];
      v[i] = keep + __shfl_xor_sync(full, send, 4);
    }
  }
  {
    const bool up = lane & 2;
    const float send = up ? v[0] : v[1];
    const float keep = up ? v[1] : v[0];
    v[0] = keep + __shfl_xor_sync(full, send, 2);
  }
  v[0] += __shfl_xor_sync(full, v[0], 1);
}

// One warp of pixels over one group of the staged batch (slots base ..
// base + GROUP - 1, n of the batch inside the count), a group the warp
// does not skip: the front-to-back pass, then the back-to-front
// gradients; emit(jj, sum) hands over the warp's sum over its pixels of
// value vi of slot base + jj (0 where no pixel keeps the slot). A pixel
// that is not active (past P) keeps no splat. suf: the pixel's suffix S,
// carried across groups.
template <class Emit>
__device__ __forceinline__ void group_grads(
    const float (*bg)[BK], const float (*bf)[BK], int base, int n,
    float px, float py, bool has_dlim, float lim, bool active,
    float lt_enter, float start, const float (&go)[FEAT_ROWS], float& suf,
    int lane, float alpha_clamp, float alpha_min, float t_min, int absgrad,
    Emit emit) {
  const unsigned full = 0xffffffffu;
  // front to back: alphas (negative where clamped, 0 where not kept),
  // log T before each splat, and the slots any pixel keeps
  float al[GROUP], ltk[GROUP];
  unsigned taken = 0u;
  float run = start;
#pragma unroll
  for (int j4 = 0; j4 < GROUP; j4 += 4) {
    composite::SplatAlpha e[4];
    composite::splat_alpha4(bg, base + j4, px, py, has_dlim, lim,
                            alpha_clamp, alpha_min, e);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int jj = j4 + u;
      float a = 0.f;
      if (active && e[u].keep && base + jj < n)
        a = e[u].raw < alpha_clamp ? e[u].alpha : -e[u].alpha;
      al[jj] = a;
      ltk[jj] = lt_enter + run;
      // a = 0 leaves run's bits (+ log1p(-0) = -0): no branch, so the
      // group's log1p polynomials overlap
      run = composite::log_t_add(run, fabsf(a));
      if (__ballot_sync(full, a != 0.f)) taken |= 1u << jj;
    }
  }

  // back to front: gradients and the suffix
#pragma unroll
  for (int jj = GROUP - 1; jj >= 0; --jj) {
    const int j = base + jj;
    float v[NV];
    if (taken >> jj & 1u) {   // uniform across the warp
      // a pixel that does not keep the slot (al = 0) gets w = 0 and
      // dq = 0: values of +-0, the suffix unchanged, no divergence
      const bool kept = al[jj] != 0.f;
      const float alpha = fabsf(al[jj]);
      const float ca = bg[2][j], cb = bg[3][j], cc = bg[4][j];
      const float dx = __fsub_rn(px, bg[0][j]);
      const float dy = __fsub_rn(py, bg[1][j]);
      const float om = 1.f - alpha;
      const float tk = expf(ltk[jj]);
      const bool m = kept && tk * om >= t_min;
      float gamma = 0.f;
#pragma unroll
      for (int c = 0; c < FEAT_ROWS; ++c) gamma += go[c] * bf[c][j];
      const float w = m ? alpha * tk : 0.f;
      const float dalpha = (m ? gamma * tk : 0.f) - suf / om;
      const float dq = al[jj] > 0.f ? -alpha * dalpha : 0.f;
      suf += gamma * w;
      const float gx = ca * dx + cb * dy;
      const float gy = cc * dy + cb * dx;
      v[0] = -dq * gx;
      v[1] = -dq * gy;
      v[2] = 0.5f * dq * dx * dx;
      v[3] = dq * dx * dy;
      v[4] = 0.5f * dq * dy * dy;
      v[5] = dq;
      v[6] = absgrad ? fabsf(v[0]) : 0.f;
      v[7] = absgrad ? fabsf(v[1]) : 0.f;
#pragma unroll
      for (int c = 0; c < FEAT_ROWS; ++c) v[8 + c] = go[c] * w;
      const bool nz = dq != 0.f || w != 0.f;
      if (__any_sync(full, nz)) {
        warp_reduce_transpose(v, lane);
      } else {
        v[0] = 0.f;
      }
    } else {
      v[0] = 0.f;   // no pixel of the warp keeps the slot
    }
    emit(jj, v[0]);
  }
}

// True where the warp adds nothing to the group: the group lies past the
// count, or every pixel of the warp enters it saturated (or is past P).
__device__ __forceinline__ bool warp_skips(int base, int n, bool active,
                                           float lt_in, float lt_skip) {
  return base >= n || __all_sync(0xffffffffu, !active || lt_in < lt_skip);
}

// composite_bwd_kernel's step: one warp over one group, the warp's sums
// written to part_w[value * PART_STRIDE + slot] (zeros where the warp
// skips the group).
__device__ __forceinline__ void group_pass(
    const float (*bg)[BK], const float (*bf)[BK], int base, int n,
    float px, float py, bool has_dlim, float lim, float lt_enter,
    float start, const float (&go)[FEAT_ROWS], float& suf, float* part_w,
    int lane, int vi, float alpha_clamp, float alpha_min, float t_min,
    float lt_skip, int absgrad) {
  if (warp_skips(base, n, true, lt_enter + start, lt_skip)) {
    // this warp adds nothing to the group's slots
    for (int i = lane; i < NV * GROUP; i += 32)
      part_w[(i / GROUP) * PART_STRIDE + i % GROUP] = 0.f;
    return;
  }
  group_grads(bg, bf, base, n, px, py, has_dlim, lim, true, lt_enter, start,
              go, suf, lane, alpha_clamp, alpha_min, t_min, absgrad,
              [&](int jj, float s) {
                if (!(lane & 1)) part_w[vi * PART_STRIDE + jj] = s;
              });
}

// Tiles of up to 16x16 pixels in whole warps: blockDim.x = P, a multiple
// of 32, at most THREADS, one thread per pixel. Dynamic shared memory:
// P / 32 warps x NV x PART_STRIDE floats.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
composite_bwd_kernel(
    const float* __restrict__ geom, const float* __restrict__ feat,
    const int32_t* __restrict__ counts, const float* __restrict__ dlim,
    const float* __restrict__ gout, const float* __restrict__ log_t_final,
    const float* __restrict__ log_t_groups, const int32_t* __restrict__ nblk,
    float* __restrict__ dgeom, float* __restrict__ dfeat, int K, int tiles_x,
    int n_tiles_img, int ts, float alpha_clamp, float alpha_min, float t_min,
    int absgrad) {
  __shared__ __align__(16) float sg[2][GEOM_ROWS][BK];
  __shared__ __align__(16) float sf[2][FEAT_ROWS][BK];
  extern __shared__ float part[];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int P = ts * ts;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = P >> 5;
  const int tl = t % n_tiles_img;
  const int x0 = (tl % tiles_x) * ts;
  const int y0 = (tl / tiles_x) * ts;
  const bool has_dlim = dlim != nullptr;
  const int count = min(max(counts[t], 0), K);
  const int nb = min(max(nblk[t], 0), K / BK);
  const float* g = geom + static_cast<size_t>(t) * 8 * K;
  const float* f = feat + static_cast<size_t>(t) * 8 * K;
  float* dg = dgeom + static_cast<size_t>(t) * 8 * K;
  float* df = dfeat + static_cast<size_t>(t) * 8 * K;
  const float* ltg = log_t_groups + static_cast<size_t>(t) * (K / GROUP) * P;
  const float* gt = gout + static_cast<size_t>(t) * FEAT_ROWS * P;
  const int geom_rows = has_dlim ? GEOM_ROWS : GEOM_ROWS - 1;
  const float lt_skip = logf(t_min) - SKIP_MARGIN;

  // the first batch to walk (the last processed) starts on its way
  if (nb > 0)
    composite::stage_batch(sg[(nb - 1) & 1], sf[(nb - 1) & 1], g, f, K,
                           (nb - 1) * BK, geom_rows);
  composite::cp_async_commit();

  // the pixel's log T after the batch, its suffix, depth limit, cotangent
  const float lim = has_dlim ? dlim[static_cast<size_t>(t) * P + tid] : 0.f;
  float lt = log_t_final[static_cast<size_t>(t) * P + tid];
  float suf = 0.f;
  float go[FEAT_ROWS];
#pragma unroll
  for (int c = 0; c < FEAT_ROWS; ++c) go[c] = gt[c * P + tid];
  // the value this lane holds after the butterfly
  const int vi = ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4 +
                 ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1);

  // slots past the processed batches: zero on all 16 rows
  const int done = nb * BK;
  const int rest = K - done;
  for (int i = tid; i < 16 * rest; i += blockDim.x) {
    const int r = i / rest;
    const int s = done + (i - r * rest);
    (r < 8 ? dg : df)[static_cast<size_t>(r & 7) * K + s] = 0.f;
  }

  // the forward's running sums at the group ends of the batch walked
  // next, held in registers
  float ends[GROUPS_PER_BATCH];
#pragma unroll
  for (int k = 0; k < GROUPS_PER_BATCH; ++k)
    ends[k] = nb > 0 ? ltg[static_cast<size_t>(
                           (nb - 1) * GROUPS_PER_BATCH + k) * P + tid]
                     : 0.f;

  for (int b = nb - 1; b >= 0; --b) {
    const int buf = b & 1;
    const int off = b * BK;
    const int n = count - off;   // splats of this batch inside the count
    // the batch in front, into the other buffer, with its group ends
    float next[GROUPS_PER_BATCH];
    if (b > 0)
      composite::stage_batch(sg[buf ^ 1], sf[buf ^ 1], g, f, K, off - BK,
                             geom_rows);
    composite::cp_async_commit();
#pragma unroll
    for (int k = 0; k < GROUPS_PER_BATCH; ++k)
      next[k] = b > 0 ? ltg[static_cast<size_t>(
                            (b - 1) * GROUPS_PER_BATCH + k) * P + tid]
                      : 0.f;
    composite::cp_async_wait<1>();   // this batch has landed
    __syncthreads();
    const float(*bg)[BK] = sg[buf];
    const float(*bf)[BK] = sf[buf];
    // log T entering the batch
    const float lt_enter = lt - ends[GROUPS_PER_BATCH - 1];

    for (int gi = GROUPS_PER_BATCH - 1; gi >= 0; --gi) {
      const int base = gi * GROUP;
      float start = 0.f;   // the batch's partial sum at the group's start
#pragma unroll
      for (int k = 0; k + 1 < GROUPS_PER_BATCH; ++k)
        if (gi == k + 1) start = ends[k];
      group_pass(bg, bf, base, n, static_cast<float>(x0 + tid % ts),
                 static_cast<float>(y0 + tid / ts), has_dlim, lim, lt_enter,
                 start, go, suf, part + warp * NV * PART_STRIDE, lane, vi,
                 alpha_clamp, alpha_min, t_min, lt_skip, absgrad);
      __syncthreads();
      // sum the warps' partials in order and write 16 rows x GROUP slots
      for (int o = tid; o < 16 * GROUP; o += blockDim.x) {
        const int r = o / GROUP;
        const int jj = o - r * GROUP;
        const int j = base + jj;
        const int src = value_of_row(r, absgrad);
        float val = 0.f;
        if (src >= 0 && j < n) {
          for (int w = 0; w < n_warps; ++w)
            val += part[(w * NV + src) * PART_STRIDE + jj];
          if (r == 5) val = -val / fmaxf(bg[5][j], 1e-30f);
        }
        (r < 8 ? dg : df)[static_cast<size_t>(r & 7) * K + off + j] = val;
      }
      __syncthreads();
    }
    lt = lt_enter;
#pragma unroll
    for (int k = 0; k < GROUPS_PER_BATCH; ++k) ends[k] = next[k];
  }
  composite::cp_async_wait<0>();
}

// One pixel over one group of the staged batch: sum of gamma w over the
// slots it keeps, with the arithmetic of group_grads (the same log T_k,
// gate and weight), in slot order.
__device__ __forceinline__ float group_weight_sum(
    const float (*bg)[BK], const float (*bf)[BK], int base, int n, float px,
    float py, bool has_dlim, float lim, float lt_enter, float start,
    const float (&go)[FEAT_ROWS], float alpha_clamp, float alpha_min,
    float t_min) {
  float acc = 0.f;
  float run = start;
#pragma unroll
  for (int j4 = 0; j4 < GROUP; j4 += 4) {
    composite::SplatAlpha e[4];
    composite::splat_alpha4(bg, base + j4, px, py, has_dlim, lim,
                            alpha_clamp, alpha_min, e);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = base + j4 + u;
      const float a = e[u].keep && j < n ? e[u].alpha : 0.f;
      const float ltk = lt_enter + run;
      run = composite::log_t_add(run, a);
      if (a != 0.f) {
        const float tk = expf(ltk);
        if (tk * (1.f - a) >= t_min) {
          float gamma = 0.f;
#pragma unroll
          for (int c = 0; c < FEAT_ROWS; ++c) gamma += go[c] * bf[c][j];
          acc += gamma * (a * tk);
        }
      }
    }
  }
  return acc;
}

// Tiles over 16x16 pixels or not in whole warps (P <= 1024). Cluster c
// takes tile order[c]: the wrapper sorts the tiles by nblk on the device,
// deepest first, so the longest chains start in the first wave and the
// short ones fill in behind them. Each tile's nblk processed batches are
// split across the `splits` blocks of one thread-block cluster: block rank r sweeps batches [r nblk / splits,
// (r + 1) nblk / splits), so the tile's chain of group steps is cut
// splits ways (the wrapper picks splits from the shapes and the SM
// count: nblk stays on the device). A block whose range is empty writes
// its share of the zeros and takes part in the cluster's barriers only.
//
// A range's sweep needs the suffix its pixels carry in from the later
// batches. So first every block with earlier batches in front of it sums
// gamma w over its own range per pixel (the sweep's log T_k, gate and
// weight, no sums over pixels); after cluster.sync() each block adds the
// later blocks' sums from their shared memory (distributed shared
// memory) in a fixed order, last block first, and sweeps its range back
// to front from that suffix. Every block rebuilds the log T entering its
// range by the one-pixel kernel's own chain of per-batch subtractions
// from log_t_final, so its alphas, gates and log T_k have the bits the
// unsplit sweep gives them; the suffix is now a sum over blocks, so the
// outputs differ from an unsplit sweep's in rounding.
//
// Within a block each of the LARGE_THREADS threads walks LARGE_PIX
// pixels, p = s * LARGE_THREADS + tid for s = 0..LARGE_PIX-1, one after
// the other within each group (pass s of warp w is a warp of 32 pixels).
// The passes of a warp add into one set of partials per batch in shared
// memory (warps x NV x BATCH_STRIDE floats: 129 KB at 512 threads), and
// each warp records which of the batch's groups it took: a group no pass
// of the warp enters unsaturated writes nothing, and the sum over warps,
// taken once per batch after one barrier, reads only the warps that took
// the group (none: the group's slots get their zeros without a read).
// Two barriers a batch, none a group. Each thread's cotangents and depth
// limits wait in shared memory, not in registers or device memory. Lanes
// past P keep no splat and read no gout, dlim, log_t_final or
// log_t_groups.
template <int NT, int PIX>
__global__ void __launch_bounds__(NT, LARGE_MIN_BLOCKS)
composite_bwd_split_kernel(
    const float* __restrict__ geom, const float* __restrict__ feat,
    const int32_t* __restrict__ counts, const float* __restrict__ dlim,
    const float* __restrict__ gout, const float* __restrict__ log_t_final,
    const float* __restrict__ log_t_groups, const int32_t* __restrict__ nblk,
    const int32_t* __restrict__ order, float* __restrict__ dgeom,
    float* __restrict__ dfeat, int K, int tiles_x, int n_tiles_img, int ts,
    float alpha_clamp, float alpha_min, float t_min, int absgrad,
    int splits) {
  constexpr int NW = NT / 32;
  __shared__ __align__(16) float sg[2][GEOM_ROWS][BK];
  __shared__ __align__(16) float sf[2][FEAT_ROWS][BK];
  __shared__ unsigned took[NW];   // per warp: the batch's groups it took
  extern __shared__ float smem[];
  float* part = smem;                                 // NW x NV x BATCH_STRIDE
  // per pixel, at s * NT + tid: its range's sum, its cotangent (8 rows),
  // its depth limit
  float* range_sum = part + NW * NV * BATCH_STRIDE;   // PIX x NT
  float* sgo = range_sum + PIX * NT;                  // FEAT_ROWS x PIX x NT
  float* slim = sgo + FEAT_ROWS * PIX * NT;           // PIX x NT

  const int cluster_id = blockIdx.x / splits;
  const int rank = blockIdx.x - cluster_id * splits;   // rank in the cluster
  const int t = order[cluster_id];
  const int tid = threadIdx.x;
  const int P = ts * ts;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tl = t % n_tiles_img;
  const int x0 = (tl % tiles_x) * ts;
  const int y0 = (tl / tiles_x) * ts;
  const bool has_dlim = dlim != nullptr;
  const int count = min(max(counts[t], 0), K);
  const int nb = min(max(nblk[t], 0), K / BK);
  const int lo = rank * nb / splits;         // this block's batches
  const int hi = (rank + 1) * nb / splits;
  const float* g = geom + static_cast<size_t>(t) * 8 * K;
  const float* f = feat + static_cast<size_t>(t) * 8 * K;
  float* dg = dgeom + static_cast<size_t>(t) * 8 * K;
  float* df = dfeat + static_cast<size_t>(t) * 8 * K;
  const float* ltg = log_t_groups + static_cast<size_t>(t) * (K / GROUP) * P;
  const float* gt = gout + static_cast<size_t>(t) * FEAT_ROWS * P;
  const int geom_rows = has_dlim ? GEOM_ROWS : GEOM_ROWS - 1;
  const float lt_skip = logf(t_min) - SKIP_MARGIN;
  // a block with earlier batches in front of it sums its range first
  const bool summed = lo > 0 && lo < hi;

  if (lo < hi)
    composite::stage_batch(sg[(hi - 1) & 1], sf[(hi - 1) & 1], g, f, K,
                           (hi - 1) * BK, geom_rows);
  composite::cp_async_commit();

  // slots past the processed batches: zero on all 16 rows, shared out
  // over the tile's blocks
  const int done = nb * BK;
  const int rest = K - done;
  for (int i = rank * NT + tid; i < 16 * rest; i += splits * NT) {
    const int r = i / rest;
    const int s = done + (i - r * rest);
    (r < 8 ? dg : df)[static_cast<size_t>(r & 7) * K + s] = 0.f;
  }

  // per pixel: the cotangent and the depth limit into shared memory (each
  // thread reads back only its own), log T after the range (the chain of
  // per-batch subtractions from log_t_final over the later batches)
  float lt[PIX], suf[PIX];
#pragma unroll
  for (int s = 0; s < PIX; ++s) {
    const int p = s * NT + tid;
    const bool active = p < P;
#pragma unroll
    for (int c = 0; c < FEAT_ROWS; ++c)
      sgo[(c * PIX + s) * NT + tid] = active ? gt[c * P + p] : 0.f;
    slim[s * NT + tid] =
        has_dlim && active ? dlim[static_cast<size_t>(t) * P + p] : 0.f;
    lt[s] = active ? log_t_final[static_cast<size_t>(t) * P + p] : 0.f;
    suf[s] = 0.f;
  }
  if (lo < hi) {
#pragma unroll 4
    for (int b = nb - 1; b >= hi; --b) {
#pragma unroll
      for (int s = 0; s < PIX; ++s) {
        const int p = s * NT + tid;
        if (p < P)
          lt[s] -= ltg[static_cast<size_t>(b * GROUPS_PER_BATCH +
                                           GROUPS_PER_BATCH - 1) * P + p];
      }
    }
  }

  // 1. the range's sum of gamma w per pixel, for the blocks in front
  // (0 from a block with none: an empty range, or no earlier batches)
  float acc[PIX];
#pragma unroll
  for (int s = 0; s < PIX; ++s) acc[s] = 0.f;
  if (summed) {
    float lt_b[PIX];
#pragma unroll
    for (int s = 0; s < PIX; ++s) lt_b[s] = lt[s];
    for (int b = hi - 1; b >= lo; --b) {
      const int buf = b & 1;
      const int off = b * BK;
      const int n = count - off;
      composite::cp_async_wait<0>();   // this batch has landed
      __syncthreads();
      if (b > lo)
        composite::stage_batch(sg[buf ^ 1], sf[buf ^ 1], g, f, K, off - BK,
                               geom_rows);
      composite::cp_async_commit();
      const float(*bg)[BK] = sg[buf];
      const float(*bf)[BK] = sf[buf];
      const float* ltb = ltg + static_cast<size_t>(b) * GROUPS_PER_BATCH * P;
#pragma unroll
      for (int s = 0; s < PIX; ++s) {
        const int p = s * NT + tid;
        if (p >= P) continue;
        const float lt_in = lt_b[s] - ltb[(GROUPS_PER_BATCH - 1) * P + p];
        lt_b[s] = lt_in;
        float go[FEAT_ROWS];
#pragma unroll
        for (int c = 0; c < FEAT_ROWS; ++c) go[c] = sgo[(c * PIX + s) * NT + tid];
        const float lim = slim[s * NT + tid];
        const float px = static_cast<float>(x0 + p % ts);
        const float py = static_cast<float>(y0 + p / ts);
        // start values only fall along the batch: the first saturated
        // group ends the pixel's walk of it
        for (int gi = 0; gi < GROUPS_PER_BATCH; ++gi) {
          const int base = gi * GROUP;
          const float start = gi > 0 ? ltb[(gi - 1) * P + p] : 0.f;
          if (base >= n || lt_in + start < lt_skip) break;
          acc[s] += group_weight_sum(bg, bf, base, n, px, py, has_dlim, lim,
                                     lt_in, start, go, alpha_clamp,
                                     alpha_min, t_min);
        }
      }
    }
    __syncthreads();   // the buffers are free again
    composite::stage_batch(sg[(hi - 1) & 1], sf[(hi - 1) & 1], g, f, K,
                           (hi - 1) * BK, geom_rows);
    composite::cp_async_commit();
  }

  // 2. the suffix from the later blocks: their sums in a fixed order
  if (splits > 1) {
#pragma unroll
    for (int s = 0; s < PIX; ++s) range_sum[s * NT + tid] = acc[s];
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (lo < hi) {
      for (int r2 = splits - 1; r2 > rank; --r2) {
        const float* other = cluster.map_shared_rank(range_sum, r2);
#pragma unroll
        for (int s = 0; s < PIX; ++s) suf[s] += other[s * NT + tid];
      }
    }
    cluster.sync();   // no block leaves while another reads its sums
  }

  // 3. the sweep of the range, back to front
  const int vi = ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4 +
                 ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1);
  float* part_w = part + warp * NV * BATCH_STRIDE;
  for (int b = hi - 1; b >= lo; --b) {
    const int buf = b & 1;
    const int off = b * BK;
    const int n = count - off;
    composite::cp_async_wait<0>();   // this batch has landed
    __syncthreads();   // and every thread is done with the batch behind
    if (b > lo)
      composite::stage_batch(sg[buf ^ 1], sf[buf ^ 1], g, f, K, off - BK,
                             geom_rows);
    composite::cp_async_commit();
    const float(*bg)[BK] = sg[buf];
    const float(*bf)[BK] = sf[buf];
    const float* ltb = ltg + static_cast<size_t>(b) * GROUPS_PER_BATCH * P;
    float lt_enter[PIX];
#pragma unroll
    for (int s = 0; s < PIX; ++s) {
      const int p = s * NT + tid;
      lt_enter[s] = p < P ? lt[s] - ltb[(GROUPS_PER_BATCH - 1) * P + p] : 0.f;
    }
    unsigned took_w = 0u;
    for (int gi = GROUPS_PER_BATCH - 1; gi >= 0; --gi) {
      const int base = gi * GROUP;
      bool wrote = false;
#pragma unroll
      for (int s = 0; s < PIX; ++s) {
        if (s * NT >= P) continue;   // uniform: no pixel on this pass
        const int p = s * NT + tid;
        const bool active = p < P;
        const float start = gi > 0 && active ? ltb[(gi - 1) * P + p] : 0.f;
        if (warp_skips(base, n, active, lt_enter[s] + start, lt_skip))
          continue;
        float go[FEAT_ROWS];
#pragma unroll
        for (int c = 0; c < FEAT_ROWS; ++c) go[c] = sgo[(c * PIX + s) * NT + tid];
        group_grads(bg, bf, base, n, static_cast<float>(x0 + p % ts),
                    static_cast<float>(y0 + p / ts), has_dlim,
                    slim[s * NT + tid], active,
                    lt_enter[s], start, go, suf[s], lane, alpha_clamp,
                    alpha_min, t_min, absgrad, [&](int jj, float sum) {
                      if (!(lane & 1)) {
                        float* q = part_w + vi * BATCH_STRIDE + base + jj;
                        *q = wrote ? *q + sum : sum;
                      }
                    });
        wrote = true;   // uniform across the warp
      }
      if (wrote) took_w |= 1u << gi;
    }
    if (lane == 0) took[warp] = took_w;
    __syncthreads();
    // sum the warps that took each group, in order; 16 rows x BK slots
    unsigned tk[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) tk[w] = took[w];
    for (int o = tid; o < 16 * BK; o += NT) {
      const int r = o / BK;
      const int j = o - r * BK;
      const int src = value_of_row(r, absgrad);
      float val = 0.f;
      if (src >= 0 && j < n) {
        const unsigned bit = 1u << (j / GROUP);
#pragma unroll
        for (int w = 0; w < NW; ++w)
          if (tk[w] & bit) val += part[(w * NV + src) * BATCH_STRIDE + j];
        if (r == 5) val = -val / fmaxf(bg[5][j], 1e-30f);
      }
      (r < 8 ? dg : df)[static_cast<size_t>(r & 7) * K + off + j] = val;
    }
#pragma unroll
    for (int s = 0; s < PIX; ++s) lt[s] = lt_enter[s];
  }
  composite::cp_async_wait<0>();
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the first CUDA error (0 = launched).
// For tiles that are not whole warps up to 16x16: splits, the blocks a
// tile (a cluster of them), 1..MAX_SPLITS, and order, the tiles in the
// order their clusters are launched (a permutation of 0..n_tiles-1);
// both ignored for the others.
int composite_bwd_launch(const float* geom, const float* feat,
                         const int32_t* counts, const float* dlim,
                         const float* gout, const float* log_t_final,
                         const float* log_t_groups, const int32_t* nblk,
                         const int32_t* order, float* dgeom, float* dfeat,
                         int n_tiles, int K,
                         int tiles_x, int n_tiles_img, int tile_size,
                         float alpha_clamp, float alpha_min, float t_min,
                         int absgrad, int splits, void* stream) {
  const int P = tile_size * tile_size;
  if (P < 1 || P > LARGE_PIX * LARGE_THREADS || K % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (P % 32 == 0 && P <= THREADS) {
    const size_t smem = sizeof(float) * (P / 32) * NV * PART_STRIDE;
    composite_bwd_kernel<<<n_tiles, P, smem, s>>>(
        geom, feat, counts, dlim, gout, log_t_final, log_t_groups, nblk,
        dgeom, dfeat, K, tiles_x, n_tiles_img, tile_size, alpha_clamp,
        alpha_min, t_min, absgrad);
    return static_cast<int>(cudaGetLastError());
  }
  if (splits < 1 || splits > MAX_SPLITS)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = composite_bwd_split_kernel<LARGE_THREADS, LARGE_PIX>;
  const size_t smem = sizeof(float) * (LARGE_WARPS * NV * BATCH_STRIDE +
                                       (FEAT_ROWS + 2) * LARGE_PIX *
                                           LARGE_THREADS);
  // above the 48 KB a block gets unasked (with the static batch
  // buffers); the attribute is the current device's, so it is set once
  // per device, on the first launch there, which comes before any graph
  // capture (two threads may both set it: that is harmless)
  static std::atomic<bool> smem_set[MAX_DEVICES];
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[device].load(std::memory_order_acquire)) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[device].store(true, std::memory_order_release);
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(n_tiles * splits));
  config.blockDim = dim3(LARGE_THREADS);
  config.dynamicSmemBytes = smem;
  config.stream = s;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = static_cast<unsigned>(splits);
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = 1;
  e = cudaLaunchKernelEx(&config, kernel, geom, feat, counts, dlim, gout,
                         log_t_final, log_t_groups, nblk, order, dgeom,
                         dfeat, K, tiles_x, n_tiles_img, tile_size,
                         alpha_clamp, alpha_min, t_min, absgrad, splits);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The slots per log_t_groups entry this library was built with; the
// wrapper checks it against its own before the first launch.
int composite_bwd_lt_group() { return GROUP; }

const char* composite_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
