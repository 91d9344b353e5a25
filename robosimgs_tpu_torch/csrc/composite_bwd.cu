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
// Work: one thread block per 16x16 tile, one thread per pixel. The
// tile's processed 128-splat batches are walked from the last to the
// first, each staged in shared memory (geom rows 0..6, feat rows 0..7,
// 7.5 KB) by cp.async while the batch behind it is swept, and each batch
// in LT_GROUP-splat groups from the last to the first. The log-T entering
// the batch is the carried log-T minus the batch's sum, and a group
// starts from the forward's partial sum at its start: both read from
// log_t_groups, so each (pixel, splat) alpha is evaluated once. For a
// group a thread walks it front to back from that partial sum, keeping
// the group's alphas and log T_k in registers, then back to front
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
// across the 8 warps through padded (bank-conflict-free) shared memory,
// once per group.
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
// against 64 B of geom/feat per splat shared by 256 pixels, 32 B of gout
// per pixel, 4 B of log_t_groups per pixel and 16 processed slots and
// 64 B of output per slot —
// operations, like the forward. The register budget: GROUP alphas and
// log T values per thread, MIN_BLOCKS blocks per SM (chosen on the card,
// PERF.md). Not yet done: TMA staging, several tiles per block,
// tensor-core forms of the sums over pixels.

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using composite::BK;
using composite::FEAT_ROWS;
using composite::GEOM_ROWS;
using composite::GROUPS_PER_BATCH;

constexpr int GROUP = composite::LT_GROUP;   // splats per register group
constexpr int MIN_BLOCKS = 2;                // resident blocks per SM
constexpr int NV = 16;         // per-pixel values summed over the tile
constexpr int MAX_THREADS = 256;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int PART_STRIDE = GROUP + 1;   // pads the partials off one bank
constexpr float SKIP_MARGIN = 1e-2f;     // in log T
static_assert(GROUP <= 32 && GROUP % 4 == 0, "GROUP");

// Values: 0 dmx, 1 dmy, 2 d conic a, 3 d conic b, 4 d conic c,
// 5 sum dq (-> d opacity), 6 |dmx|, 7 |dmy|, 8..15 dfeat rows 0..7.

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

__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
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
  __shared__ float part[MAX_WARPS * NV * PART_STRIDE];

  const unsigned full = 0xffffffffu;
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int n_warps = P >> 5;
  const int tl = t % n_tiles_img;
  const float px = static_cast<float>((tl % tiles_x) * ts + p % ts);
  const float py = static_cast<float>((tl / tiles_x) * ts + p / ts);
  const bool has_dlim = dlim != nullptr;
  const float lim = has_dlim ? dlim[static_cast<size_t>(t) * P + p] : 0.f;
  const int count = min(max(counts[t], 0), K);
  const int nb = min(max(nblk[t], 0), K / BK);
  const float* g = geom + static_cast<size_t>(t) * 8 * K;
  const float* f = feat + static_cast<size_t>(t) * 8 * K;
  float* dg = dgeom + static_cast<size_t>(t) * 8 * K;
  float* df = dfeat + static_cast<size_t>(t) * 8 * K;
  const float* ltg =
      log_t_groups + static_cast<size_t>(t) * (K / GROUP) * P + p;
  const int geom_rows = has_dlim ? GEOM_ROWS : GEOM_ROWS - 1;
  const float lt_skip = logf(t_min) - SKIP_MARGIN;

  // the first batch to walk (the last processed) starts on its way
  if (nb > 0)
    composite::stage_batch(sg[(nb - 1) & 1], sf[(nb - 1) & 1], g, f, K,
                           (nb - 1) * BK, geom_rows);
  composite::cp_async_commit();

  float go[FEAT_ROWS];
#pragma unroll
  for (int c = 0; c < FEAT_ROWS; ++c)
    go[c] = gout[(static_cast<size_t>(t) * FEAT_ROWS + c) * P + p];
  float lt = log_t_final[static_cast<size_t>(t) * P + p];  // after the batch
  float suf = 0.f;
  // the value this lane holds after the butterfly
  const int vi = ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4 +
                 ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1);

  // slots past the processed batches: zero on all 16 rows
  const int done = nb * BK;
  const int rest = K - done;
  for (int i = p; i < 16 * rest; i += P) {
    const int r = i / rest;
    const int s = done + (i - r * rest);
    (r < 8 ? dg : df)[static_cast<size_t>(r & 7) * K + s] = 0.f;
  }

  // the forward's running sums at the group ends of the batch walked next
  float ends[GROUPS_PER_BATCH];
#pragma unroll
  for (int k = 0; k < GROUPS_PER_BATCH; ++k)
    ends[k] = nb > 0 ? ltg[static_cast<size_t>(
                           (nb - 1) * GROUPS_PER_BATCH + k) * P]
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
                            (b - 1) * GROUPS_PER_BATCH + k) * P]
                      : 0.f;
    composite::cp_async_wait<1>();   // this batch has landed
    __syncthreads();
    const float(*bg)[BK] = sg[buf];
    const float(*bf)[BK] = sf[buf];
    const float lt_enter = lt - ends[GROUPS_PER_BATCH - 1];   // entering

    for (int gi = GROUPS_PER_BATCH - 1; gi >= 0; --gi) {
      const int base = gi * GROUP;
      float start = 0.f;   // the batch's partial sum at the group's start
#pragma unroll
      for (int k = 0; k + 1 < GROUPS_PER_BATCH; ++k)
        if (gi == k + 1) start = ends[k];
      bool skip = base >= n;   // uniform across the block
      if (!skip) skip = __all_sync(full, lt_enter + start < lt_skip);

      if (skip) {
        // this warp adds nothing to the group's slots
        for (int i = lane; i < NV * GROUP; i += 32)
          part[(warp * NV + i / GROUP) * PART_STRIDE + i % GROUP] = 0.f;
      } else {
        // front to back: alphas (negative where clamped, 0 where not
        // kept), log T before each splat, and the slots any pixel keeps
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
            if (e[u].keep && base + jj < n)
              a = e[u].raw < alpha_clamp ? e[u].alpha : -e[u].alpha;
            al[jj] = a;
            ltk[jj] = lt_enter + run;
            // a = 0 leaves run's bits (+ log1p(-0) = -0): no branch, so
            // the group's log1p polynomials overlap
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
          if (!(lane & 1)) part[(warp * NV + vi) * PART_STRIDE + jj] = v[0];
        }
      }
      __syncthreads();
      // sum the warps' partials and write 16 rows x GROUP slots
      for (int o = p; o < 16 * GROUP; o += P) {
        const int r = o / GROUP;
        const int jj = o - r * GROUP;
        const int j = base + jj;
        // output row -> value index (-1: written as zero)
        int src;
        if (r < 6) {
          src = r;
        } else if (r == 6) {
          src = -1;
        } else if (r == 7) {
          src = absgrad ? 6 : -1;
        } else if (r < 15) {
          src = r;
        } else {
          src = absgrad ? 7 : 15;
        }
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

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
int composite_bwd_launch(const float* geom, const float* feat,
                         const int32_t* counts, const float* dlim,
                         const float* gout, const float* log_t_final,
                         const float* log_t_groups, const int32_t* nblk,
                         float* dgeom, float* dfeat, int n_tiles, int K,
                         int tiles_x, int n_tiles_img, int tile_size,
                         float alpha_clamp, float alpha_min, float t_min,
                         int absgrad, void* stream) {
  const int P = tile_size * tile_size;
  if (P % 32 != 0 || P > MAX_THREADS || K % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  composite_bwd_kernel<<<n_tiles, P, 0, static_cast<cudaStream_t>(stream)>>>(
      geom, feat, counts, dlim, gout, log_t_final, log_t_groups, nblk, dgeom,
      dfeat, K, tiles_x, n_tiles_img, tile_size, alpha_clamp, alpha_min,
      t_min, absgrad);
  return static_cast<int>(cudaGetLastError());
}

// The slots per log_t_groups entry this library was built with; the
// wrapper checks it against its own before the first launch.
int composite_bwd_lt_group() { return GROUP; }

const char* composite_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
