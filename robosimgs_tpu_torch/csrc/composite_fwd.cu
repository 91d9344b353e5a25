// Per-tile front-to-back compositing forward for Hopper (sm_90a).
//
// Replaces robosimgs_tpu/render/pallas_kernels.py::_fwd_kernel (entry
// composite_fwd_pallas). Built by robosimgs_tpu_torch/render/_build.py
// with nvcc into a shared library with a plain C interface; called
// through ctypes by robosimgs_tpu_torch/render/kernels.py::composite_fwd.
//
// Work: one thread block per 16x16 tile, one thread per pixel. The
// tile's depth-sorted splats are staged through shared memory in
// batches of BK = 128 (geom rows 0..6 and feat rows 0..7, 7.5 KB); each
// thread walks a batch in order, keeping its linear transmittance T, its
// log-transmittance and its 8 channel accumulators in registers.
//
// Semantics (RenderConfig): q = .5(a dx^2 + c dy^2) + b dx dy,
// alpha = min(alpha_clamp, op e^-q); a splat is kept iff
// alpha >= alpha_min, q >= 0 and (with a depth limit) depth <= dlim;
// w = alpha T is accumulated while T (1 - alpha) >= t_min.
//
// Residuals for the backward, identical in meaning to the Pallas
// kernel's: the tile stops only at a batch boundary where no pixel has
// T >= t_min (__syncthreads_or), nblk counts the batches processed, and
// log_t_final sums log1p(-alpha) over EVERY kept splat of the processed
// batches (not "log T at the stop point"), exact where linear T
// underflows. It is summed batch by batch (composite_common.cuh), the
// grouping composite_bwd.cu takes back.
//
// Bound on this card: per evaluated (pixel, splat) pair about 20 FP32
// operations plus two SFU calls (expf, log1pf), against 64 B of
// geom/feat per splat shared by 256 pixels and 40 B of output per
// pixel — far on the operations side of the H100's ridge. The design
// reads each splat once per tile from device memory into shared memory
// (broadcast reads, no bank conflicts) and keeps all per-pixel state in
// registers; the early exit at batch boundaries skips the depth tail of
// saturated tiles. Not yet done: per-pixel exit, cp.async/TMA double
// buffering of the next batch, several tiles per block.

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using composite::BK;
using composite::FEAT_ROWS;
using composite::GEOM_ROWS;

__global__ void composite_fwd_kernel(
    const float* __restrict__ geom, const float* __restrict__ feat,
    const int32_t* __restrict__ counts, const float* __restrict__ dlim,
    float* __restrict__ out, float* __restrict__ log_t_final,
    int32_t* __restrict__ nblk, int K, int tiles_x, int n_tiles_img, int ts,
    float alpha_clamp, float alpha_min, float t_min) {
  __shared__ float sg[GEOM_ROWS][BK];
  __shared__ float sf[FEAT_ROWS][BK];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int tl = t % n_tiles_img;
  const float px = static_cast<float>((tl % tiles_x) * ts + p % ts);
  const float py = static_cast<float>((tl / tiles_x) * ts + p / ts);
  const bool has_dlim = dlim != nullptr;
  const float lim = has_dlim ? dlim[static_cast<size_t>(t) * P + p] : 0.f;
  const int count = min(max(counts[t], 0), K);
  const float* g = geom + static_cast<size_t>(t) * 8 * K;
  const float* f = feat + static_cast<size_t>(t) * 8 * K;

  float T = 1.f;
  float lt = 0.f;
  float acc[FEAT_ROWS];
#pragma unroll
  for (int c = 0; c < FEAT_ROWS; ++c) acc[c] = 0.f;

  int nb = 0;
  bool live = true;  // uniform across the block
  for (int off = 0; off < count && live; off += BK) {
    const int n = min(BK, count - off);
    __syncthreads();  // the previous batch is consumed
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

    float s = 0.f;   // log-T sum of the batch
    for (int j = 0; j < n; ++j) {
      const composite::SplatAlpha a = composite::splat_alpha(
          sg, j, px, py, has_dlim, lim, alpha_clamp, alpha_min);
      if (a.keep) {  // else alpha = 0: no weight, T and log-T unchanged
        const float t_after = T * (1.f - a.alpha);
        if (t_after >= t_min) {
          const float w = a.alpha * T;
#pragma unroll
          for (int c = 0; c < FEAT_ROWS; ++c) acc[c] += w * sf[c][j];
        }
        T = t_after;
        s += log1pf(-a.alpha);
      }
    }
    lt += s;
    ++nb;
    live = __syncthreads_or(T >= t_min) != 0;
  }

  float* o = out + static_cast<size_t>(t) * FEAT_ROWS * P;
#pragma unroll
  for (int c = 0; c < FEAT_ROWS; ++c) o[c * P + p] = acc[c];
  log_t_final[static_cast<size_t>(t) * P + p] = lt;
  if (p == 0) nblk[t] = nb;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
int composite_fwd_launch(const float* geom, const float* feat,
                         const int32_t* counts, const float* dlim, float* out,
                         float* log_t_final, int32_t* nblk, int n_tiles, int K,
                         int tiles_x, int n_tiles_img, int tile_size,
                         float alpha_clamp, float alpha_min, float t_min,
                         void* stream) {
  const int P = tile_size * tile_size;
  composite_fwd_kernel<<<n_tiles, P, 0, static_cast<cudaStream_t>(stream)>>>(
      geom, feat, counts, dlim, out, log_t_final, nblk, K, tiles_x,
      n_tiles_img, tile_size, alpha_clamp, alpha_min, t_min);
  return static_cast<int>(cudaGetLastError());
}

const char* composite_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
