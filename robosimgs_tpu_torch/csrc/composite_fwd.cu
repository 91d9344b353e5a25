// Per-tile front-to-back compositing forward for Hopper (sm_90a).
//
// Replaces robosimgs_tpu/render/pallas_kernels.py::_fwd_kernel (entry
// composite_fwd_pallas). Built by robosimgs_tpu_torch/render/_build.py
// with nvcc into a shared library with a plain C interface; called
// through ctypes by robosimgs_tpu_torch/render/kernels.py::composite_fwd.
//
// Work: one thread block per tile, one thread per pixel: tiles of up to
// 16x16 in whole warps run a 256-thread instance of the kernel, any other
// up to 32x32 a 1024-thread instance, which evaluates 4 alphas ahead (not
// 8) to fit its 64 registers and lets a partial last warp vote over its
// own lanes (a vote over a mask held in a register costs the 256-thread
// instance ~10 %, so that one votes over the constant full mask). The
// tile's depth-sorted splats are staged through shared memory in
// batches of BK = 128 (geom rows 0..6 and feat rows 0..7, 7.5 KB), two
// buffers deep: cp.async copies the next batch while the current one is
// composited. Each thread walks a batch in order, keeping its linear
// transmittance T, its log-transmittance and its 8 channel accumulators
// in registers. It evaluates the alphas of AHEAD splats at a time (their
// geometry read as 16-byte rows, the exp of each independent of T)
// before the serial T update takes them in order, so the exp latency
// overlaps the chain. A pair that a pixel does not keep goes through the
// update with alpha = 0, which leaves every bit of its state as it was,
// so the lanes of a warp never diverge: the weight is skipped only where
// no pixel of the warp has one (a vote), and every log1p is taken, so
// the AHEAD polynomials overlap. Each pixel's order of operations is
// unchanged.
//
// Semantics (RenderConfig): q = .5(a dx^2 + c dy^2) + b dx dy,
// alpha = min(alpha_clamp, op e^-q); a splat is kept iff
// alpha >= alpha_min, q >= 0 and (with a depth limit) depth <= dlim;
// w = alpha T is accumulated while T (1 - alpha) >= t_min.
//
// Residuals for the backward. nblk and log_t_final are identical in
// meaning to the Pallas kernel's: the tile stops only at a batch boundary
// where no pixel has T >= t_min (__syncthreads_or), nblk counts the
// batches processed, and log_t_final sums log1p(-alpha) over EVERY kept
// splat of the processed batches (not "log T at the stop point"), exact
// where linear T underflows. It is summed batch by batch
// (composite_common.cuh), the grouping composite_bwd.cu takes back.
// log_t_groups (T, K / LT_GROUP, P) holds the batch's running sum at the
// end of each LT_GROUP-slot group of the processed batches, so the
// backward needs no alpha of its own to find where a group starts; the
// entries past the processed batches are not written (the backward never
// reads them, and at the 640x480 view's K = 1024 they would be most of
// the kernel's bytes).
//
// Bound on this card: per evaluated (pixel, splat) pair about 20 FP32
// operations plus two SFU calls (expf, log1pf), against 64 B of
// geom/feat per splat shared by 256 pixels, 40 B of output per pixel and
// 4 B of log_t_groups per pixel and 16 processed slots — far on the
// operations side of the H100's ridge. The design reads each splat once
// per tile from device memory into shared memory (broadcast reads, no
// bank conflicts) and keeps all per-pixel state in registers; the early
// exit at batch boundaries skips the depth tail of saturated tiles. Not
// yet done: TMA staging, several tiles per block (the bench shape fills
// one wave with two blocks per SM), finding what holds it (PERF.md: it
// spends about 13x its operation count's time).

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using composite::BK;
using composite::FEAT_ROWS;
using composite::GEOM_ROWS;
using composite::GROUPS_PER_BATCH;
using composite::LT_GROUP;

constexpr int SMALL_THREADS = 256;    // tiles of up to 16x16 pixels
constexpr int LARGE_THREADS = 1024;   // up to 32x32

// AHEAD: splats whose alphas are evaluated together; WHOLE_WARPS: the
// tile's pixel count is a multiple of 32
template <int MAX_THREADS, int AHEAD, bool WHOLE_WARPS>
__global__ void __launch_bounds__(MAX_THREADS) composite_fwd_kernel(
    const float* __restrict__ geom, const float* __restrict__ feat,
    const int32_t* __restrict__ counts, const float* __restrict__ dlim,
    float* __restrict__ out, float* __restrict__ log_t_final,
    float* __restrict__ log_t_groups, int32_t* __restrict__ nblk, int K,
    int tiles_x, int n_tiles_img, int ts, float alpha_clamp, float alpha_min,
    float t_min) {
  static_assert(AHEAD % 4 == 0 && LT_GROUP % AHEAD == 0, "AHEAD");
  __shared__ __align__(16) float sg[2][GEOM_ROWS][BK];
  __shared__ __align__(16) float sf[2][FEAT_ROWS][BK];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  // the lanes of this thread's warp (the last warp of a tile whose pixel
  // count is not a multiple of 32 is partial)
  const int lanes = WHOLE_WARPS ? 32 : min(32, P - (p & ~31));
  const unsigned warp_mask = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u;
  const int tl = t % n_tiles_img;
  const float px = static_cast<float>((tl % tiles_x) * ts + p % ts);
  const float py = static_cast<float>((tl / tiles_x) * ts + p / ts);
  const bool has_dlim = dlim != nullptr;
  const float lim = has_dlim ? dlim[static_cast<size_t>(t) * P + p] : 0.f;
  const int count = min(max(counts[t], 0), K);
  const float* g = geom + static_cast<size_t>(t) * 8 * K;
  const float* f = feat + static_cast<size_t>(t) * 8 * K;
  const int n_groups = K / LT_GROUP;
  float* ltg = log_t_groups + static_cast<size_t>(t) * n_groups * P + p;
  const int geom_rows = has_dlim ? GEOM_ROWS : GEOM_ROWS - 1;

  float T = 1.f;
  float lt = 0.f;
  float acc[FEAT_ROWS];
#pragma unroll
  for (int c = 0; c < FEAT_ROWS; ++c) acc[c] = 0.f;

  if (count > 0)
    composite::stage_batch(sg[0], sf[0], g, f, K, 0, geom_rows);
  composite::cp_async_commit();
  int nb = 0;
  bool live = true;  // uniform across the block
  for (int off = 0; off < count && live; off += BK) {
    const int buf = nb & 1;
    if (off + BK < count)   // the next batch, into the other buffer
      composite::stage_batch(sg[buf ^ 1], sf[buf ^ 1], g, f, K, off + BK,
                             geom_rows);
    composite::cp_async_commit();
    composite::cp_async_wait<1>();   // this batch has landed
    __syncthreads();
    const float(*bg)[BK] = sg[buf];
    const float(*bf)[BK] = sf[buf];
    const int n = min(BK, count - off);

    float s = 0.f;   // log-T sum of the batch
    int group = nb * GROUPS_PER_BATCH;   // next log_t_groups entry
    for (int j0 = 0; j0 < n; j0 += AHEAD) {
      composite::SplatAlpha e[AHEAD];
#pragma unroll
      for (int h = 0; h < AHEAD; h += 4)
        composite::splat_alpha4(bg, j0 + h, px, py, has_dlim, lim,
                                alpha_clamp, alpha_min, e + h);
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        // a pair not kept: a = 0, so T (T * 1), the sums (+ 0 * feat)
        // and log-T (+ log1p(-0) = -0) keep their bits
        const bool kept = e[u].keep && j0 + u < n;
        const float a = kept ? e[u].alpha : 0.f;
        const float t_after = T * (1.f - a);
        const bool weighted = kept && t_after >= t_min;
        if (__any_sync(warp_mask, weighted)) {
          const float w = weighted ? a * T : 0.f;
#pragma unroll
          for (int c = 0; c < FEAT_ROWS; ++c) acc[c] += w * bf[c][j0 + u];
        }
        T = t_after;
        s = composite::log_t_add(s, a);
      }
      if ((j0 + AHEAD) % LT_GROUP == 0)
        ltg[static_cast<size_t>(group++) * P] = s;
    }
    // groups wholly past the count end where the sum ends
    for (; group < (nb + 1) * GROUPS_PER_BATCH; ++group)
      ltg[static_cast<size_t>(group) * P] = s;
    lt += s;
    ++nb;
    live = __syncthreads_or(T >= t_min) != 0;
  }
  composite::cp_async_wait<0>();   // no copy may land after the block exits

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
                         float* log_t_final, float* log_t_groups,
                         int32_t* nblk, int n_tiles, int K, int tiles_x,
                         int n_tiles_img, int tile_size, float alpha_clamp,
                         float alpha_min, float t_min, void* stream) {
  const int P = tile_size * tile_size;
  if (P < 1 || P > LARGE_THREADS || K % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = P <= SMALL_THREADS && P % 32 == 0
                          ? composite_fwd_kernel<SMALL_THREADS, 8, true>
                          : composite_fwd_kernel<LARGE_THREADS, 4, false>;
  kernel<<<n_tiles, P, 0, static_cast<cudaStream_t>(stream)>>>(
      geom, feat, counts, dlim, out, log_t_final, log_t_groups, nblk, K,
      tiles_x, n_tiles_img, tile_size, alpha_clamp, alpha_min, t_min);
  return static_cast<int>(cudaGetLastError());
}

// The slots per log_t_groups entry this library was built with; the
// wrapper checks it against its own before the first launch.
int composite_fwd_lt_group() { return LT_GROUP; }

const char* composite_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
