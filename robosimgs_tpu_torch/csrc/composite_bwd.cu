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
// log_t_final (T,P,1) and nblk (T,). Outputs dgeom/dfeat (T,8,K), every
// (row, slot) written exactly once, no atomics: the per-Gaussian sum is
// the caller's (the transpose of the binner's gather).
//
// Work: one thread block per 16x16 tile, one thread per pixel. The
// tile's processed 128-splat batches are walked from the last to the
// first, each staged once in shared memory (geom rows 0..6, feat rows
// 0..7, 7.5 KB), and each batch in 32-splat groups from the last to the
// first. Each thread first sums the batch's log1p(-alpha) front to back
// as the forward did (composite_common.cuh), keeping the partial sums at
// the group starts; the log-T entering the batch is the carried log-T
// minus that sum. For a group it walks the group front to back from its
// partial sum, keeping the group's alphas and log T_k in registers, then
// back to front carrying the suffix S = sum_{j>k} gamma_j w_j (gamma =
// gout . feat). Transmittance is never rebuilt by dividing a linear T
// (saturated pixels sit near log T = -350, where linear T is 0 in f32)
// nor by a per-splat subtraction chain from log_t_final.
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
// once per 32 splats. A warp whose 32 pixels take nothing from a splat
// skips its butterfly.
//
// Bound on this card: per evaluated (pixel, splat) pair the forward's
// ~17 FP32 operations (the alpha test), ~8 more per kept pair (the
// transmittance and the gate) and ~66 more per pair that carries weight
// (gamma's 8 FMAs, the 14 products and their sums over the tile),
// against 64 B of geom/feat per splat shared by 256 pixels, 32 B of gout
// per pixel and 64 B of output per slot — operations, like the forward.
// The design evaluates each pair's alpha twice (the batch's log-T sum,
// then its group), which the bound does not count. Not yet done:
// per-pixel skip of the saturated tail, cp.async/TMA staging of the
// next batch, several tiles per block, tensor-core forms of the sums
// over pixels.

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using composite::BK;
using composite::FEAT_ROWS;
using composite::GEOM_ROWS;

constexpr int GROUP = 32;      // splats per register-held group
constexpr int NV = 16;         // per-pixel values summed over the tile
constexpr int MAX_THREADS = 256;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int PART_STRIDE = GROUP + 1;   // pads the partials off one bank

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

__global__ void __launch_bounds__(MAX_THREADS) composite_bwd_kernel(
    const float* __restrict__ geom, const float* __restrict__ feat,
    const int32_t* __restrict__ counts, const float* __restrict__ dlim,
    const float* __restrict__ gout, const float* __restrict__ log_t_final,
    const int32_t* __restrict__ nblk, float* __restrict__ dgeom,
    float* __restrict__ dfeat, int K, int tiles_x, int n_tiles_img, int ts,
    float alpha_clamp, float alpha_min, float t_min, int absgrad) {
  __shared__ float sg[GEOM_ROWS][BK];
  __shared__ float sf[FEAT_ROWS][BK];
  __shared__ float part[MAX_WARPS * NV * PART_STRIDE];
  __shared__ float group_start[BK / GROUP][MAX_THREADS];  // log-T partials

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

  for (int b = nb - 1; b >= 0; --b) {
    const int off = b * BK;
    const int n = count - off;   // splats of this batch inside the count
    __syncthreads();             // the previous batch is consumed
    for (int i = p; i < (GEOM_ROWS + FEAT_ROWS) * BK; i += P) {
      const int r = i / BK;
      const int j = i - r * BK;
      if (j < n) {
        if (r < GEOM_ROWS) {
          sg[r][j] = g[static_cast<size_t>(r) * K + off + j];
        } else {
          sf[r - GEOM_ROWS][j] =
              f[static_cast<size_t>(r - GEOM_ROWS) * K + off + j];
        }
      }
    }
    __syncthreads();

    // the batch's log-T sum front to back, as the forward summed it
    float s = 0.f;
    for (int j = 0; j < min(n, BK); ++j) {
      if (j % GROUP == 0) group_start[j / GROUP][p] = s;
      const composite::SplatAlpha e = composite::splat_alpha(
          sg, j, px, py, has_dlim, lim, alpha_clamp, alpha_min);
      if (e.keep) s += log1pf(-e.alpha);
    }
    const float lt_enter = lt - s;   // log T entering the batch

    for (int gi = BK / GROUP - 1; gi >= 0; --gi) {
      const int base = gi * GROUP;
      // front to back: alphas (negative where clamped, 0 where not kept)
      // and log T before each splat
      float al[GROUP], ltk[GROUP];
      float run = base < n ? group_start[gi][p] : 0.f;
#pragma unroll
      for (int jj = 0; jj < GROUP; ++jj) {
        float a = 0.f;
        if (base + jj < n) {
          const composite::SplatAlpha e = composite::splat_alpha(
              sg, base + jj, px, py, has_dlim, lim, alpha_clamp, alpha_min);
          if (e.keep) a = e.raw < alpha_clamp ? e.alpha : -e.alpha;
        }
        al[jj] = a;
        ltk[jj] = lt_enter + run;
        if (a != 0.f) run += log1pf(-fabsf(a));
      }

      // back to front: gradients and the suffix
#pragma unroll
      for (int jj = GROUP - 1; jj >= 0; --jj) {
        const int j = base + jj;
        float v[NV];
#pragma unroll
        for (int i = 0; i < NV; ++i) v[i] = 0.f;
        bool nz = false;
        if (al[jj] != 0.f) {
          const float alpha = fabsf(al[jj]);
          const float ca = sg[2][j], cb = sg[3][j], cc = sg[4][j];
          const float dx = __fsub_rn(px, sg[0][j]);
          const float dy = __fsub_rn(py, sg[1][j]);
          const float om = 1.f - alpha;
          const float tk = expf(ltk[jj]);
          const bool m = tk * om >= t_min;
          float gamma = 0.f;
#pragma unroll
          for (int c = 0; c < FEAT_ROWS; ++c) gamma += go[c] * sf[c][j];
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
          if (absgrad) {
            v[6] = fabsf(v[0]);
            v[7] = fabsf(v[1]);
          }
#pragma unroll
          for (int c = 0; c < FEAT_ROWS; ++c) v[8 + c] = go[c] * w;
          nz = dq != 0.f || w != 0.f;
        }
        if (__any_sync(0xffffffffu, nz)) {
          warp_reduce_transpose(v, lane);
        } else {
          v[0] = 0.f;
        }
        if (!(lane & 1)) part[(warp * NV + vi) * PART_STRIDE + jj] = v[0];
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
          if (r == 5) val = -val / fmaxf(sg[5][j], 1e-30f);
        }
        (r < 8 ? dg : df)[static_cast<size_t>(r & 7) * K + off + j] = val;
      }
      __syncthreads();
    }
    lt = lt_enter;
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
int composite_bwd_launch(const float* geom, const float* feat,
                         const int32_t* counts, const float* dlim,
                         const float* gout, const float* log_t_final,
                         const int32_t* nblk, float* dgeom, float* dfeat,
                         int n_tiles, int K, int tiles_x, int n_tiles_img,
                         int tile_size, float alpha_clamp, float alpha_min,
                         float t_min, int absgrad, void* stream) {
  const int P = tile_size * tile_size;
  if (P % 32 != 0 || P > MAX_THREADS) return static_cast<int>(
      cudaErrorInvalidValue);
  composite_bwd_kernel<<<n_tiles, P, 0, static_cast<cudaStream_t>(stream)>>>(
      geom, feat, counts, dlim, gout, log_t_final, nblk, dgeom, dfeat, K,
      tiles_x, n_tiles_img, tile_size, alpha_clamp, alpha_min, t_min, absgrad);
  return static_cast<int>(cudaGetLastError());
}

const char* composite_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
