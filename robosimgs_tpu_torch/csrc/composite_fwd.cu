// Per-tile front-to-back compositing forward for Hopper (sm_90a).
//
// Replaces robosimgs_tpu/render/pallas_kernels.py::_fwd_kernel (entry
// composite_fwd_pallas). Built by robosimgs_tpu_torch/render/_build.py
// with nvcc into a shared library with a plain C interface; called
// through ctypes by robosimgs_tpu_torch/render/kernels.py::composite_fwd.
//
// Work: one thread per pixel, 256 threads a block. Tiles of up to 16x16
// in whole warps run one block a tile. Any other tile, up to 32x32, runs
// as a thread-block cluster of S = ceil(P / 256) blocks: block rank r
// takes the band of the tile's rows [r ts / S, (r + 1) ts / S) (at most
// 256 pixels; render/kernels.py::fwd_bands is the same rule), so a 32x32
// tile's chain of batches runs on four SMs at once instead of one. Bands
// in whole warps of one size (32x32, 24x24) vote over the constant full
// mask; the others let a partial last warp vote over its own lanes (a
// vote over a mask held in a register costs ~10 %), and threads past a
// short band only stage and vote. The tile's depth-sorted splats are
// staged through shared memory in batches of BK = 128 (geom rows 0..6
// and feat rows 0..7, 7.5 KB), two buffers deep: cp.async copies the
// next batch while the current one is composited (each block of a
// cluster stages every batch itself). Each thread walks a batch in
// order, keeping its linear transmittance T, its log-transmittance and
// its 8 channel accumulators in registers. It evaluates the alphas of 8
// splats at a time (their geometry read as 16-byte rows, the exp of each
// independent of T) before the serial T update takes them in order, so
// the exp latency overlaps the chain. A pair that a pixel does not keep
// goes through the update with alpha = 0, which leaves every bit of its
// state as it was, so the lanes of a warp never diverge: the weight is
// skipped only where no pixel of the warp has one (a vote), and every
// log1p is taken, so the polynomials overlap. Each pixel's order of
// operations is the same in every instance.
//
// The cluster instances may also skip, exactly, the slots that no pixel
// of a box can keep (`misses`: q's least value over the box against
// ln(op / alpha_min), with a margin for the rounding). Once a batch has
// landed they list the slots to walk, with their geometry, in order:
// each warp for the box its own pixels span (SKIP_WARP: a 32x32 tile's
// warp is one row, which most of the tile's splats miss), or the block
// once for its band (SKIP_BAND: one test a slot, no list a warp);
// SKIP_NONE walks every slot. The wrapper picks the grain
// (render/kernels.py::fwd_skip_grain) and may be asked for any of the
// three. A skipped pair would have gone through the update with
// alpha = 0 on every lane of the warp, so each pixel's state, and
// log_t_groups written at the group ends, keep their bits: the three
// grains' outputs are equal. Given a `pairs` buffer, each warp adds the
// (pixel, slot) pairs it walked and those of the batches it processed,
// so the share skipped is the kernel's own count.
//
// The stop decision is the tile's: at each batch boundary a block takes
// __syncthreads_or(T >= t_min) over its pixels and writes it into a slot
// of every peer's shared memory (distributed shared memory, one slot a
// rank and batch parity); after cluster.sync() each block ORs the S
// flags, so every block of a tile stops after the same batch, the one
// where a single block for the whole tile would have stopped. All
// outputs are therefore the one-block-a-tile kernel's bit for bit (the
// sign of a zero aside, where a warp's vote takes other pixels).
//
// Semantics (RenderConfig): q = .5(a dx^2 + c dy^2) + b dx dy,
// alpha = min(alpha_clamp, op e^-q); a splat is kept iff
// alpha >= alpha_min, q >= 0 and (with a depth limit) depth <= dlim;
// w = alpha T is accumulated while T (1 - alpha) >= t_min.
//
// Residuals for the backward. nblk and log_t_final are identical in
// meaning to the Pallas kernel's: the tile stops only at a batch boundary
// where no pixel has T >= t_min, nblk counts the batches processed, and
// log_t_final sums log1p(-alpha) over EVERY kept splat of the processed
// batches (not "log T at the stop point"), exact where linear T
// underflows. It is summed batch by batch (composite_common.cuh), the
// grouping composite_bwd.cu takes back. log_t_groups (T, K / LT_GROUP, P)
// holds the batch's running sum at the end of each LT_GROUP-slot group
// of the processed batches, so the backward needs no alpha of its own to
// find where a group starts; the entries past the processed batches are
// not written (the backward never reads them, and at the 640x480 view's
// K = 1024 they would be most of the kernel's bytes).
//
// Bound on this card: per evaluated (pixel, splat) pair about 20 FP32
// operations plus two SFU calls (expf, log1pf), against 64 B of
// geom/feat per splat shared by the tile's pixels, 40 B of output per
// pixel and 4 B of log_t_groups per pixel and 16 processed slots — far
// on the operations side of the H100's ridge. The design reads each
// splat once per block from device memory into shared memory (broadcast
// reads, no bank conflicts) and keeps all per-pixel state in registers;
// the early exit at batch boundaries skips the depth tail of saturated
// tiles. Not yet done: TMA staging (a multicast of each batch to the
// cluster), several tiles per block at 16x16, finding what holds it
// (PERF.md: it spends over 10x its operation count's time).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

namespace cg = cooperative_groups;

using composite::BK;
using composite::FEAT_ROWS;
using composite::GEOM_ROWS;
using composite::GROUPS_PER_BATCH;
using composite::LT_GROUP;

constexpr int THREADS = 256;       // a block: one pixel a thread
constexpr int MAX_CLUSTER = 8;     // blocks a tile (the portable cluster)
constexpr int MAX_PIXELS = 1024;   // 32x32
constexpr int AHEAD = 8;           // alphas evaluated before the T chain
constexpr int WARPS = THREADS / 32;
// The slots of a batch a cluster instance walks: with SKIP_WARP only
// those some pixel of the box its warp spans may keep (`misses`), with
// SKIP_BAND those some pixel of the block's band may keep, with
// SKIP_NONE (the one-block instance's) every slot.
constexpr int SKIP_NONE = 0, SKIP_WARP = 1, SKIP_BAND = 2;

// Whether no pixel center in the box [x0, x1] x [y0, y1] (pixel
// coordinates) can keep splat j of the staged batch sg. q's least value
// on the box lies on its boundary, or is 0 where the mean lies inside;
// on each edge q is a parabola (a, c > 0) whose least value lies at its
// vertex clamped to the edge. The splat is skipped only where that
// least q exceeds ln(op / alpha_min) by more than the rounding of the
// kernel's q (within 2e-6 of the largest sum of |terms| of q over the
// box), of expf and of op * e^-q, and of this test itself: then
// op e^-q < alpha_min on every pixel, so no pixel keeps it. Never where
// a <= 0, c <= 0, op <= 0 or anything is not finite.
__device__ __forceinline__ bool misses(const float (*sg)[BK], int j,
                                       float x0, float x1, float y0,
                                       float y1, float log_alpha_min) {
  const float mx = sg[0][j], my = sg[1][j];
  const float a = sg[2][j], b = sg[3][j], c = sg[4][j], op = sg[5][j];
  if (!(a > 0.f) || !(c > 0.f) || !(op > 0.f) || !isfinite(mx) ||
      !isfinite(my) || !isfinite(a) || !isfinite(b) || !isfinite(c) ||
      !isfinite(op))
    return false;
  const float dx0 = x0 - mx, dx1 = x1 - mx, dy0 = y0 - my, dy1 = y1 - my;
  auto q = [&](float dx, float dy) {
    return 0.5f * (a * dx * dx + c * dy * dy) + b * dx * dy;
  };
  auto on_row = [&](float dy) {   // least q on the edge at row offset dy
    return q(fminf(fmaxf(-b * dy / a, dx0), dx1), dy);
  };
  auto on_col = [&](float dx) {   // and on the edge at column offset dx
    return q(dx, fminf(fmaxf(-b * dx / c, dy0), dy1));
  };
  float q_min = fminf(fminf(on_row(dy0), on_row(dy1)),
                      fminf(on_col(dx0), on_col(dx1)));
  if (dx0 <= 0.f && dx1 >= 0.f && dy0 <= 0.f && dy1 >= 0.f)
    q_min = fminf(q_min, 0.f);
  const float dxm = fmaxf(fabsf(dx0), fabsf(dx1));
  const float dym = fmaxf(fabsf(dy0), fabsf(dy1));
  const float terms =
      0.5f * (a * dxm * dxm + c * dym * dym) + fabsf(b) * dxm * dym;
  const float thr = logf(op) - log_alpha_min;
  const float margin = 2e-6f * terms + 1e-5f * (1.f + fabsf(thr));
  return isfinite(q_min) && isfinite(margin) && isfinite(thr) &&
         q_min - margin > thr;
}

// Lists slot j of the staged batch sg at entry i of `list`: its geometry
// rows 0..rows-1 and, in row GEOM_ROWS, j.
__device__ __forceinline__ void list_slot(float (*list)[BK],
                                          const float (*sg)[BK], int j,
                                          int i, int rows) {
  for (int r = 0; r < rows; ++r) list[r][i] = sg[r][j];
  list[GEOM_ROWS][i] = __int_as_float(j);
}

// WHOLE_WARPS: every block's pixel count is a multiple of 32 (and, in a
// cluster, the same); CLUSTER: a tile is a cluster of blocks, each
// taking a band of its rows (else one block takes the whole tile);
// GRAIN: the slots walked, SKIP_NONE, SKIP_WARP or SKIP_BAND (a cluster
// only). pairs: null, or [walked, processed] (pixel, slot) pairs that a
// cluster instance adds to (the one-block instance's code is PR 3's)
template <bool WHOLE_WARPS, bool CLUSTER, int GRAIN>
__global__ void __launch_bounds__(THREADS) composite_fwd_kernel(
    const float* __restrict__ geom, const float* __restrict__ feat,
    const int32_t* __restrict__ counts, const float* __restrict__ dlim,
    float* __restrict__ out, float* __restrict__ log_t_final,
    float* __restrict__ log_t_groups, int32_t* __restrict__ nblk,
    unsigned long long* __restrict__ pairs, int K, int tiles_x,
    int n_tiles_img, int ts, float alpha_clamp, float alpha_min,
    float t_min) {
  static_assert(AHEAD % 4 == 0 && LT_GROUP % AHEAD == 0, "AHEAD");
  static_assert(CLUSTER || GRAIN == SKIP_NONE, "one block walks every slot");
  __shared__ __align__(16) float sg[2][GEOM_ROWS][BK];
  __shared__ __align__(16) float sf[2][FEAT_ROWS][BK];
  // per batch parity, each rank's stop vote (written by that rank)
  __shared__ int votes[CLUSTER ? 2 : 1][MAX_CLUSTER];
  constexpr int skip = GRAIN;
  // the slots of the batch a warp (SKIP_WARP) or the block (SKIP_BAND)
  // walks, in order: their geometry rows 0..6 and, in row 7, the slot
  __shared__ __align__(16)
      float walk[skip == SKIP_WARP ? WARPS : 1][GEOM_ROWS + 1][BK];
  __shared__ int listed[WARPS];   // SKIP_BAND: slots each warp listed

  // this block's tile t, rank and band: tile pixels [p0, p0 + n_pix)
  int t = blockIdx.x, rank = 0, n_ranks = 1, p0 = 0;
  int n_pix = blockDim.x;
  if constexpr (CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    n_ranks = static_cast<int>(cluster.num_blocks());
    rank = static_cast<int>(cluster.block_rank());
    t = blockIdx.x / n_ranks;
    const int row0 = rank * ts / n_ranks;
    p0 = row0 * ts;
    n_pix = ((rank + 1) * ts / n_ranks - row0) * ts;
  }
  const int P = CLUSTER ? ts * ts : blockDim.x;   // the tile's pixels
  const int tid = threadIdx.x;
  const int p = p0 + tid;                         // pixel in the tile
  // whether this thread has a pixel (threads past a short band do not)
  const bool active = !CLUSTER || WHOLE_WARPS || tid < n_pix;
  // the lanes of this thread's warp (the last warp of a band whose pixel
  // count is not a multiple of 32 is partial)
  const int lanes =
      WHOLE_WARPS ? 32 : min(32, max(1, n_pix - (tid & ~31)));
  const unsigned warp_mask = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u;
  const int tl = t % n_tiles_img;
  const float px = static_cast<float>((tl % tiles_x) * ts + p % ts);
  const float py = static_cast<float>((tl / tiles_x) * ts + p / ts);
  const bool has_dlim = dlim != nullptr;
  const float lim =
      has_dlim && active ? dlim[static_cast<size_t>(t) * P + p] : 0.f;
  const int count = min(max(counts[t], 0), K);
  const float* g = geom + static_cast<size_t>(t) * 8 * K;
  const float* f = feat + static_cast<size_t>(t) * 8 * K;
  const int n_groups = K / LT_GROUP;
  float* ltg = log_t_groups + static_cast<size_t>(t) * n_groups * P + p;
  const int geom_rows = has_dlim ? GEOM_ROWS : GEOM_ROWS - 1;
  // the box that the pixels tested for a skip span: the warp's pixels
  // (tile pixels [w0, w1)) or the block's band, in rows y0..y1 and
  // columns x0..x1 (the tile's width once it spans a row end)
  const int warp = tid >> 5, lane = tid & 31;
  const int w0 = skip == SKIP_WARP ? p0 + (tid & ~31) : p0;
  const int w1 = skip == SKIP_WARP ? w0 + lanes : p0 + n_pix;
  const int tx0 = (tl % tiles_x) * ts, ty0 = (tl / tiles_x) * ts;
  const bool one_row = w0 / ts == (w1 - 1) / ts;
  const float x0 = static_cast<float>(tx0 + (one_row ? w0 % ts : 0));
  const float x1 =
      static_cast<float>(tx0 + (one_row ? (w1 - 1) % ts : ts - 1));
  const float y0 = static_cast<float>(ty0 + w0 / ts);
  const float y1 = static_cast<float>(ty0 + (w1 - 1) / ts);
  const float log_alpha_min = logf(alpha_min);

  float T = 1.f;
  float lt = 0.f;
  float acc[FEAT_ROWS];
#pragma unroll
  for (int c = 0; c < FEAT_ROWS; ++c) acc[c] = 0.f;

  if (count > 0)
    composite::stage_batch(sg[0], sf[0], g, f, K, 0, geom_rows);
  composite::cp_async_commit();
  int nb = 0;
  bool live = true;  // uniform across the tile
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

    // the slots to walk: rows 0..6 and the slot (row 7) of each
    const float(*wl)[BK] = walk[skip == SKIP_WARP ? warp : 0];
    int n_walk = n;
    if constexpr (skip == SKIP_WARP) {
      // the warp's lanes test `lanes` slots at a time and list them in
      // order (a partial warp covers the batch in more rounds)
      if (active) {
        n_walk = 0;
        for (int j0 = 0; j0 < n; j0 += lanes) {
          const int j = j0 + lane;
          const bool need = j < n && !misses(bg, j, x0, x1, y0, y1,
                                             log_alpha_min);
          const unsigned m = __ballot_sync(warp_mask, need);
          if (need)
            list_slot(walk[warp], bg, j,
                      n_walk + __popc(m & ((1u << lane) - 1u)), geom_rows);
          n_walk += __popc(m);
        }
        __syncwarp(warp_mask);
      }
    } else if constexpr (skip == SKIP_BAND) {
      // the block's threads test one slot each and list them in order
      const int block_lanes =
          min(32, static_cast<int>(blockDim.x) - (tid & ~31));
      const unsigned block_mask =
          block_lanes == 32 ? 0xffffffffu : (1u << block_lanes) - 1u;
      const int n_warps = (blockDim.x + 31) / 32;
      n_walk = 0;
      for (int j0 = 0; j0 < n; j0 += blockDim.x) {
        const int j = j0 + tid;
        const bool need =
            j < n && !misses(bg, j, x0, x1, y0, y1, log_alpha_min);
        const unsigned m = __ballot_sync(block_mask, need);
        if (lane == 0) listed[warp] = __popc(m);
        __syncthreads();
        int before = 0, total = 0;
        for (int w = 0; w < n_warps; ++w) {
          before += w < warp ? listed[w] : 0;
          total += listed[w];
        }
        if (need)
          list_slot(walk[0], bg, j,
                    n_walk + before + __popc(m & ((1u << lane) - 1u)),
                    geom_rows);
        n_walk += total;
        __syncthreads();   // the list is whole; `listed` may be rewritten
      }
    }
    if (active && skip != SKIP_NONE) {
      float s = 0.f;   // log-T sum of the batch
      int group = 0;   // the batch's next log_t_groups entry
      float* ltb = ltg + static_cast<size_t>(nb) * GROUPS_PER_BATCH * P;
      for (int i0 = 0; i0 < n_walk; i0 += AHEAD) {
        composite::SplatAlpha e[AHEAD];
#pragma unroll
        for (int h = 0; h < AHEAD; h += 4)
          composite::splat_alpha4(wl, i0 + h, px, py, has_dlim, lim,
                                  alpha_clamp, alpha_min, e + h);
        int js[AHEAD];      // the entries' slots (BK past the list)
        float s_at[AHEAD];  // the sum after each entry
        const float s0 = s;
#pragma unroll
        for (int u = 0; u < AHEAD; ++u) {
          const bool in = i0 + u < n_walk;
          js[u] = in ? __float_as_int(wl[GEOM_ROWS][i0 + u]) : BK;
          // the update of the walk below, slot js[u]
          const bool kept = e[u].keep && in;
          const float a = kept ? e[u].alpha : 0.f;
          const float t_after = T * (1.f - a);
          const bool weighted = kept && t_after >= t_min;
          if (__any_sync(warp_mask, weighted)) {
            const float w = weighted ? a * T : 0.f;
#pragma unroll
            for (int c = 0; c < FEAT_ROWS; ++c)
              acc[c] += w * bf[c][min(js[u], BK - 1)];
          }
          T = t_after;
          s = composite::log_t_add(s, a);
          s_at[u] = s;
        }
        // the groups that end before the next entry's slot are complete:
        // each holds the sum after its last entry
        const int next = i0 + AHEAD < n_walk
                             ? __float_as_int(wl[GEOM_ROWS][i0 + AHEAD])
                             : BK;
        for (; group < next / LT_GROUP; ++group) {
          float v = s0;
#pragma unroll
          for (int u = 0; u < AHEAD; ++u)
            if (js[u] < (group + 1) * LT_GROUP) v = s_at[u];
          ltb[static_cast<size_t>(group) * P] = v;
        }
      }
      for (; group < GROUPS_PER_BATCH; ++group)
        ltb[static_cast<size_t>(group) * P] = s;
      if constexpr (skip == SKIP_WARP)
        __syncwarp(warp_mask);   // the list is read before the next batch's
      lt += s;
    } else if (active) {
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
    }
    if constexpr (CLUSTER) {
      if (pairs != nullptr && active && lane == 0) {
        atomicAdd(&pairs[0], static_cast<unsigned long long>(n_walk) * lanes);
        atomicAdd(&pairs[1], static_cast<unsigned long long>(n) * lanes);
      }
    }
    ++nb;
    if constexpr (CLUSTER) {
      // the block's vote into slot `rank` of every rank's votes[parity]:
      // a rank that reads batch nb's votes after the cluster barrier
      // cannot see batch nb + 2's, which come after the next barrier
      const int vote = __syncthreads_or(active && T >= t_min);
      cg::cluster_group cluster = cg::this_cluster();
      if (tid < n_ranks)
        cluster.map_shared_rank(&votes[nb & 1][0], tid)[rank] = vote;
      cluster.sync();
      int any = 0;
      for (int r = 0; r < n_ranks; ++r) any |= votes[nb & 1][r];
      live = any != 0;
    } else {
      live = __syncthreads_or(T >= t_min) != 0;
    }
  }
  composite::cp_async_wait<0>();   // no copy may land after the block exits
  // no block leaves while a peer may still write into its votes
  if constexpr (CLUSTER) cg::this_cluster().sync();

  if (!active) return;
  float* o = out + static_cast<size_t>(t) * FEAT_ROWS * P;
#pragma unroll
  for (int c = 0; c < FEAT_ROWS; ++c) o[c * P + p] = acc[c];
  log_t_final[static_cast<size_t>(t) * P + p] = lt;
  if (p == 0) nblk[t] = nb;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// A whole-warp tile of up to 16x16 pixels runs one block a tile without
// a cluster (grain SKIP_NONE, no pair count); any other a cluster of
// S = ceil(tile_size / (256 / tile_size)) blocks (ceil(P / 256) for every
// tile up to 32x32; render/kernels.py::fwd_bands mirrors the rule),
// walking the slots of `grain`: SKIP_NONE (0), SKIP_WARP (1) or
// SKIP_BAND (2). pairs: null, or two zeroed-or-running counters that the
// kernel adds its walked and processed (pixel, slot) pairs to.
int composite_fwd_launch(const float* geom, const float* feat,
                         const int32_t* counts, const float* dlim, float* out,
                         float* log_t_final, float* log_t_groups,
                         int32_t* nblk, unsigned long long* pairs,
                         int n_tiles, int K, int tiles_x, int n_tiles_img,
                         int tile_size, int grain, float alpha_clamp,
                         float alpha_min, float t_min, void* stream) {
  const int P = tile_size * tile_size;
  if (P < 1 || P > MAX_PIXELS || K % BK != 0 || grain < SKIP_NONE ||
      grain > SKIP_BAND)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (P <= THREADS && P % 32 == 0) {
    if (grain != SKIP_NONE || pairs != nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    composite_fwd_kernel<true, false, SKIP_NONE><<<n_tiles, P, 0, s>>>(
        geom, feat, counts, dlim, out, log_t_final, log_t_groups, nblk,
        pairs, K, tiles_x, n_tiles_img, tile_size, alpha_clamp, alpha_min,
        t_min);
    return static_cast<int>(cudaGetLastError());
  }
  const int band = THREADS / tile_size;                  // rows a band
  const int cluster = (tile_size + band - 1) / band;     // blocks a tile
  const int rows = (tile_size + cluster - 1) / cluster;  // the tallest band
  const int threads = rows * tile_size;
  const bool whole = tile_size % cluster == 0 && threads % 32 == 0;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(n_tiles * cluster));
  config.blockDim = dim3(static_cast<unsigned>(threads));
  config.dynamicSmemBytes = 0;
  config.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(cluster);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  using Kernel = decltype(&composite_fwd_kernel<true, true, SKIP_NONE>);
  const Kernel kernels[2][3] = {
      {composite_fwd_kernel<false, true, SKIP_NONE>,
       composite_fwd_kernel<false, true, SKIP_WARP>,
       composite_fwd_kernel<false, true, SKIP_BAND>},
      {composite_fwd_kernel<true, true, SKIP_NONE>,
       composite_fwd_kernel<true, true, SKIP_WARP>,
       composite_fwd_kernel<true, true, SKIP_BAND>}};
  const cudaError_t e = cudaLaunchKernelEx(
      &config, kernels[whole][grain], geom, feat, counts, dlim, out,
      log_t_final, log_t_groups, nblk, pairs, K, tiles_x, n_tiles_img,
      tile_size, alpha_clamp, alpha_min, t_min);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The slots per log_t_groups entry this library was built with; the
// wrapper checks it against its own before the first launch.
int composite_fwd_lt_group() { return LT_GROUP; }

const char* composite_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
