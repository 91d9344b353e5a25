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
// Work: one thread block of 256 threads per tile. Tiles of up to 16x16
// pixels in whole warps run an instance with one thread per pixel; any
// other tile of up to 32x32 (P <= 1024, P not a multiple of 32 included)
// an instance whose thread walks up to four pixels, p = s * 256 +
// threadIdx.x for s = 0..3, one after the other within each group, so
// that it keeps the first instance's registers per pixel (a 1024-thread
// block would have 64 a thread, and the group's alphas and log T values
// alone take 32). Its 32-pixel warps are virtual: warp s * 8 + w is
// threads of warp w on pass s, reduced as one. Lanes past P take every
// splat with alpha = 0 and add +-0 to every sum over pixels; they read
// no gout, dlim, log_t_final or log_t_groups. The
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
// across the warps in order (8 at 16x16, 32 at 32x32) through padded
// (bank-conflict-free) dynamic shared memory, once per group: 8.5 KB at
// 16x16, 34 KB at 32x32, beside the 15 KB double-buffered batch.
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
// against 64 B of geom/feat per splat shared by the tile's 256 (1024)
// pixels, 32 B of gout per pixel, 4 B of log_t_groups per pixel and 16
// processed slots and 64 B of output per slot — operations, like the
// forward, at either tile size. The register budget: GROUP alphas and
// log T values per thread, MIN_BLOCKS blocks per SM (chosen on the card,
// PERF.md); the four-pixel instance reloads a pixel's gout and group
// starts from device memory (L1) on each pass instead of holding them.
// Not yet done: TMA staging, several tiles per block, tensor-core forms
// of the sums over pixels.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "composite_common.cuh"

namespace {

using composite::BK;
using composite::FEAT_ROWS;
using composite::GEOM_ROWS;
using composite::GROUPS_PER_BATCH;

constexpr int GROUP = composite::LT_GROUP;   // splats per register group
constexpr int MIN_BLOCKS = 2;                // resident blocks per SM
constexpr int NV = 16;         // per-pixel values summed over the tile
constexpr int THREADS = 256;   // threads per block, both instances
constexpr int WARPS = THREADS / 32;
constexpr int LARGE_PIX = 4;   // pixels per thread of the large instance
constexpr int PART_STRIDE = GROUP + 1;   // pads the partials off one bank
constexpr float SKIP_MARGIN = 1e-2f;     // in log T
constexpr int MAX_DEVICES = 64;          // cards the launcher tracks
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

// One warp of pixels over one group of the staged batch (slots base ..
// base + GROUP - 1, n of the batch inside the count): the front-to-back
// pass, then the back-to-front gradients, their sums over the warp's
// pixels written to part_w[value * PART_STRIDE + slot] (zeros where the
// warp skips the group). A pixel that is not active (past P) keeps no
// splat. suf: the pixel's suffix S, carried across groups.
__device__ __forceinline__ void group_pass(
    const float (*bg)[BK], const float (*bf)[BK], int base, int n,
    float px, float py, bool has_dlim, float lim, bool active,
    float lt_enter, float start, const float (&go)[FEAT_ROWS], float& suf,
    float* part_w, int lane, int vi, float alpha_clamp, float alpha_min,
    float t_min, float lt_skip, int absgrad) {
  const unsigned full = 0xffffffffu;
  bool skip = base >= n;   // uniform across the block
  if (!skip) skip = __all_sync(full, !active || lt_enter + start < lt_skip);

  if (skip) {
    // this warp adds nothing to the group's slots
    for (int i = lane; i < NV * GROUP; i += 32)
      part_w[(i / GROUP) * PART_STRIDE + i % GROUP] = 0.f;
    return;
  }
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
    if (!(lane & 1)) part_w[vi * PART_STRIDE + jj] = v[0];
  }
}

// PIX: pixels per thread (1: P = blockDim.x, a multiple of 32, at most
// THREADS; LARGE_PIX: blockDim.x = THREADS, any P up to LARGE_PIX *
// THREADS). Dynamic shared memory: PIX * THREADS / 32 (PIX = 1: P / 32)
// warps x NV x PART_STRIDE floats.
template <int PIX>
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
  const int n_warps = (P + 31) >> 5;   // the last may be partial
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

  // per pixel p = s * THREADS + tid: log T after the batch, the suffix,
  // the depth limit; PIX = 1 also holds the cotangent
  float lt[PIX], suf[PIX], lim[PIX];
  float go[FEAT_ROWS];
#pragma unroll
  for (int s = 0; s < PIX; ++s) {
    const int p = s * THREADS + tid;
    const bool active = PIX == 1 || p < P;
    lim[s] = has_dlim && active ? dlim[static_cast<size_t>(t) * P + p] : 0.f;
    lt[s] = active ? log_t_final[static_cast<size_t>(t) * P + p] : 0.f;
    suf[s] = 0.f;
  }
  if constexpr (PIX == 1) {
#pragma unroll
    for (int c = 0; c < FEAT_ROWS; ++c) go[c] = gt[c * P + tid];
  }
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

  // PIX = 1: the forward's running sums at the group ends of the batch
  // walked next, held in registers (the other instance reads them when
  // it needs them)
  float ends[GROUPS_PER_BATCH];
  if constexpr (PIX == 1) {
#pragma unroll
    for (int k = 0; k < GROUPS_PER_BATCH; ++k)
      ends[k] = nb > 0 ? ltg[static_cast<size_t>(
                             (nb - 1) * GROUPS_PER_BATCH + k) * P + tid]
                       : 0.f;
  }

  for (int b = nb - 1; b >= 0; --b) {
    const int buf = b & 1;
    const int off = b * BK;
    const int n = count - off;   // splats of this batch inside the count
    const float* ltb = ltg + static_cast<size_t>(b) * GROUPS_PER_BATCH * P;
    // the batch in front, into the other buffer, with its group ends
    float next[GROUPS_PER_BATCH];
    if (b > 0)
      composite::stage_batch(sg[buf ^ 1], sf[buf ^ 1], g, f, K, off - BK,
                             geom_rows);
    composite::cp_async_commit();
    if constexpr (PIX == 1) {
#pragma unroll
      for (int k = 0; k < GROUPS_PER_BATCH; ++k)
        next[k] = b > 0 ? ltg[static_cast<size_t>(
                              (b - 1) * GROUPS_PER_BATCH + k) * P + tid]
                        : 0.f;
    }
    composite::cp_async_wait<1>();   // this batch has landed
    __syncthreads();
    const float(*bg)[BK] = sg[buf];
    const float(*bf)[BK] = sf[buf];
    // log T entering the batch
    float lt_enter[PIX];
#pragma unroll
    for (int s = 0; s < PIX; ++s) {
      const int p = s * THREADS + tid;
      if constexpr (PIX == 1) {
        lt_enter[s] = lt[s] - ends[GROUPS_PER_BATCH - 1];
      } else {
        lt_enter[s] = p < P ? lt[s] - ltb[(GROUPS_PER_BATCH - 1) * P + p]
                            : 0.f;
      }
    }

    for (int gi = GROUPS_PER_BATCH - 1; gi >= 0; --gi) {
      const int base = gi * GROUP;
#pragma unroll
      for (int s = 0; s < PIX; ++s) {
        if (s * THREADS >= P) continue;   // uniform: no pixel on this pass
        const int p = s * THREADS + tid;
        const bool active = PIX == 1 || p < P;
        float start = 0.f;   // the batch's partial sum at the group's start
        if constexpr (PIX == 1) {
#pragma unroll
          for (int k = 0; k + 1 < GROUPS_PER_BATCH; ++k)
            if (gi == k + 1) start = ends[k];
        } else {
          if (gi > 0 && active) start = ltb[(gi - 1) * P + p];
#pragma unroll
          for (int c = 0; c < FEAT_ROWS; ++c)
            go[c] = active ? gt[c * P + p] : 0.f;
        }
        group_pass(bg, bf, base, n, static_cast<float>(x0 + p % ts),
                   static_cast<float>(y0 + p / ts), has_dlim, lim[s], active,
                   lt_enter[s], start, go, suf[s],
                   part + (s * WARPS + warp) * NV * PART_STRIDE, lane, vi,
                   alpha_clamp, alpha_min, t_min, lt_skip, absgrad);
      }
      __syncthreads();
      // sum the warps' partials in order and write 16 rows x GROUP slots
      for (int o = tid; o < 16 * GROUP; o += blockDim.x) {
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
#pragma unroll
    for (int s = 0; s < PIX; ++s) lt[s] = lt_enter[s];
    if constexpr (PIX == 1) {
#pragma unroll
      for (int k = 0; k < GROUPS_PER_BATCH; ++k) ends[k] = next[k];
    }
  }
  composite::cp_async_wait<0>();
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the first CUDA error (0 = launched).
int composite_bwd_launch(const float* geom, const float* feat,
                         const int32_t* counts, const float* dlim,
                         const float* gout, const float* log_t_final,
                         const float* log_t_groups, const int32_t* nblk,
                         float* dgeom, float* dfeat, int n_tiles, int K,
                         int tiles_x, int n_tiles_img, int tile_size,
                         float alpha_clamp, float alpha_min, float t_min,
                         int absgrad, void* stream) {
  const int P = tile_size * tile_size;
  if (P < 1 || P > LARGE_PIX * THREADS || K % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (P % 32 == 0 && P <= THREADS) {
    const size_t smem = sizeof(float) * (P / 32) * NV * PART_STRIDE;
    composite_bwd_kernel<1><<<n_tiles, P, smem, s>>>(
        geom, feat, counts, dlim, gout, log_t_final, log_t_groups, nblk,
        dgeom, dfeat, K, tiles_x, n_tiles_img, tile_size, alpha_clamp,
        alpha_min, t_min, absgrad);
  } else {
    const size_t smem = sizeof(float) * LARGE_PIX * WARPS * NV * PART_STRIDE;
    // above the 48 KB a block gets unasked (with the static batch
    // buffers); the attribute is the current device's, so it is set
    // once per device, on the first launch there, which comes before
    // any graph capture (two threads may both set it: that is harmless)
    static std::atomic<bool> smem_set[MAX_DEVICES];
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (device >= MAX_DEVICES)
      return static_cast<int>(cudaErrorInvalidDevice);
    if (!smem_set[device].load(std::memory_order_acquire)) {
      e = cudaFuncSetAttribute(composite_bwd_kernel<LARGE_PIX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      smem_set[device].store(true, std::memory_order_release);
    }
    composite_bwd_kernel<LARGE_PIX><<<n_tiles, THREADS, smem, s>>>(
        geom, feat, counts, dlim, gout, log_t_final, log_t_groups, nblk,
        dgeom, dfeat, K, tiles_x, n_tiles_img, tile_size, alpha_clamp,
        alpha_min, t_min, absgrad);
  }
  return static_cast<int>(cudaGetLastError());
}

// The slots per log_t_groups entry this library was built with; the
// wrapper checks it against its own before the first launch.
int composite_bwd_lt_group() { return GROUP; }

const char* composite_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
