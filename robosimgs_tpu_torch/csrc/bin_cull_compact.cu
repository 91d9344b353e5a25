// Binning's exact tile cull and row compaction, fused, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package bins in XLA
// (robosimgs_tpu/render/binning.py::bin_and_gather_packed's cull and row
// sort), and the port did the same in plain PyTorch, as a few dozen
// elementwise launches over an (n, Mb) grid of bbox slots and a
// short-row sort of that grid. Built by robosimgs_tpu_torch/render/
// _build.py with nvcc into a shared library with a plain C interface;
// called through ctypes by robosimgs_tpu_torch/render/cull.py::
// bin_cull_compact.
//
// Work, for each depth-ordered Gaussian i: enumerate the first Mb tiles
// of its inclusive tile bbox row-major (render/tiles.py::_bbox_slots),
// keep a slot where the Gaussian is valid (radius > 0) and, with the
// exact cull, the ellipse can reach the tile (_cull_keep_q: q's least
// value over the tile's pixel centres is at most ln(op / alpha_min), or
// the conic is not definitely PSD), write the kept tile ids in
// enumeration order to
// row i of tid (n, M), the sentinel n_tiles in the rest of the row, and
// surv[i] (the kept slots among all Mb, those past M included) and
// cover[i] (the bbox's tile count).
//
// Why compaction needs no sort: a bbox lies inside the tile grid
// (tile_bbox clamps it), so its tile ids rise strictly with the slot
// index, and the sentinel exceeds every tile id. The row sort the plain
// version runs therefore keeps the survivors' order and moves the
// sentinels to the tail: an order-keeping compaction.
//
// Bound on this card: bytes. Per Gaussian 64 B read (its 7-float bbox
// row, its cut, its 4 int64 bbox edges) and M * 8 + 16 B written; at the
// staged 1M Gaussians with M 48 about 0.46 GB (0.14 ms at 3.35 TB/s), at
// a 200k rollout camera with M 80 about 0.14 GB (0.04 ms). The plain
// version moves the (n, Mb) temporaries of every elementwise step and
// sorts them. The design: one warp a Gaussian, 8 a block. The lanes take
// slots lane + 32 j, only over the slots inside the bbox (rounds past
// min(cover, Mb) are never entered, so a Gaussian covering 9 tiles costs
// one round of the cull's arithmetic, not Mb / 32); each round a ballot
// and a popcount of the lanes below give every kept slot its column, so
// the row is written once, in place, with no temporaries and no sort.
// The Gaussian's parameters are read once per warp (one broadcast load
// each).
//
// Bits: every keep decision equals the plain torch version's on the card.
// Each product, sum and quotient is rounded on its own (__fmul_rn and
// friends: no FMA contraction), in torch's order of evaluation; minimum
// and maximum return NaN when either input is NaN, as torch.minimum and
// torch.maximum do; integers follow torch's int64 arithmetic. The cut
// ln(max(op, 1e-12) / alpha_min) comes computed by torch
// (tiles.py::cull_qcut), so its rounding is torch's own.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;             // Gaussians a block
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;

// torch.maximum / torch.minimum: NaN if either input is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// q(u, v) = .5 a u^2 + b u v + .5 c v^2 as torch evaluates
// (0.5 * ca) * u * u + cb * u * v + (0.5 * cc) * v * v; ha = 0.5 a,
// hc = 0.5 c
__device__ __forceinline__ float quad(float ha, float b, float hc, float u,
                                      float v) {
  return __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(ha, u), u),
                             __fmul_rn(__fmul_rn(b, u), v)),
                   __fmul_rn(__fmul_rn(hc, v), v));
}

// int64 arithmetic as torch's (two's complement, wrapping)
__device__ __forceinline__ long long wrap_add(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}
__device__ __forceinline__ long long wrap_mul(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) *
                                static_cast<unsigned long long>(b));
}

__global__ void __launch_bounds__(THREADS) bin_cull_compact_kernel(
    const float* __restrict__ bbox, const float* __restrict__ qcut,
    const long long* __restrict__ tx0, const long long* __restrict__ ty0,
    const long long* __restrict__ tx1, const long long* __restrict__ ty1,
    long long* __restrict__ tid, long long* __restrict__ surv,
    long long* __restrict__ cover, int n, int n_slots, int max_tiles,
    long long tiles_x, long long n_tiles, int tile_size) {
  const int lane = threadIdx.x & 31;
  const long long i =
      static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (i >= n) return;   // the whole warp
  const float* g = bbox + i * 7;
  const float mx = g[0], my = g[1], radius = g[2];
  const float a = g[3], b = g[4], c = g[5];
  const long long x0 = tx0[i], y0 = ty0[i];
  // tiles.py::_bbox_slots: bw = clamp_min(tx1 - tx0 + 1, 0), likewise bh,
  // cover = bw * bh; slot e is in the bbox iff e < cover
  const long long bw = max(wrap_add(wrap_add(tx1[i], -x0), 1), 0LL);
  const long long bh = max(wrap_add(wrap_add(ty1[i], -y0), 1), 0LL);
  const long long cov = wrap_mul(bw, bh);
  const long long bw_safe = max(bw, 1LL);
  const bool exact = qcut != nullptr;
  const float cut = exact ? qcut[i] : 0.f;
  // the slots that can be kept: inside the bbox, of a valid Gaussian
  const int n_enum = radius > 0.f ? static_cast<int>(min(
      cov < 0 ? 0LL : cov, static_cast<long long>(n_slots))) : 0;
  // tiles.py::_cull_keep_q's per-Gaussian terms
  const float ts = static_cast<float>(tile_size);
  const float ts1 = static_cast<float>(static_cast<double>(tile_size) - 1.0);
  const float a_s = a != a ? a : fmaxf(a, static_cast<float>(1e-12));
  const float c_s = c != c ? c : fmaxf(c, static_cast<float>(1e-12));
  const float ha = __fmul_rn(a, 0.5f), hc = __fmul_rn(c, 0.5f);
  const float nb = -b;
  const bool psd = a > 0.f && c > 0.f;

  long long* out = tid + i * max_tiles;
  int kept = 0;
  for (int base = 0; base < n_enum; base += 32) {
    const int e = base + lane;
    bool keep = false;
    long long t = 0;
    if (e < n_enum) {
      // row = floor(e / bw_safe), col = e - row * bw_safe (e >= 0)
      const long long row = bw_safe > e ? 0LL
          : static_cast<long long>(static_cast<unsigned>(e) /
                                   static_cast<unsigned>(bw_safe));
      const long long col = e - row * bw_safe;
      const long long gx = wrap_add(x0, col), gy = wrap_add(y0, row);
      t = wrap_add(wrap_mul(gy, tiles_x), gx);
      keep = true;
      if (exact && psd) {
        const float u0 = __fsub_rn(__fmul_rn(__ll2float_rn(gx), ts), mx);
        const float v0 = __fsub_rn(__fmul_rn(__ll2float_rn(gy), ts), my);
        const float u1 = __fadd_rn(u0, ts1), v1 = __fadd_rn(v0, ts1);
        // u fixed, v free in [v0, v1]; v fixed, u free in [u0, u1]
        auto edge_u = [&](float uf) {
          const float vs = nan_min(
              nan_max(__fdiv_rn(__fmul_rn(nb, uf), c_s), v0), v1);
          return quad(ha, b, hc, uf, vs);
        };
        auto edge_v = [&](float vf) {
          const float us = nan_min(
              nan_max(__fdiv_rn(__fmul_rn(nb, vf), a_s), u0), u1);
          return quad(ha, b, hc, us, vf);
        };
        float qmin = nan_min(nan_min(edge_u(u0), edge_u(u1)),
                             nan_min(edge_v(v0), edge_v(v1)));
        if (u0 <= 0.f && 0.f <= u1 && v0 <= 0.f && 0.f <= v1) qmin = 0.f;
        keep = qmin <= cut;
      }
    }
    const unsigned votes = __ballot_sync(FULL, keep);
    if (keep) {
      const int col = kept + __popc(votes & ((1u << lane) - 1u));
      if (col < max_tiles) out[col] = t;
    }
    kept += __popc(votes);
  }
  for (int col = min(kept, max_tiles) + lane; col < max_tiles; col += 32)
    out[col] = n_tiles;
  if (lane == 0) {
    surv[i] = kept;
    cover[i] = cov;
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// bbox (n, 7) float32 [mx, my, radius, conic a, b, c, opacity]; qcut (n,)
// float32, or null for no exact cull; tx0, ty0, tx1, ty1 (n,) int64, the
// inclusive tile bbox; tid (n, max_tiles), surv and cover (n,) int64.
int bin_cull_compact_launch(const float* bbox, const float* qcut,
                            const long long* tx0, const long long* ty0,
                            const long long* tx1, const long long* ty1,
                            long long* tid, long long* surv,
                            long long* cover, int n, int n_slots,
                            int max_tiles, long long tiles_x,
                            long long n_tiles, int tile_size, void* stream) {
  if (n < 1 || max_tiles < 1 || n_slots < max_tiles || tile_size < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + WARPS - 1) / WARPS);
  bin_cull_compact_kernel<<<blocks, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      bbox, qcut, tx0, ty0, tx1, ty1, tid, surv, cover, n, n_slots,
      max_tiles, tiles_x, n_tiles, tile_size);
  return static_cast<int>(cudaGetLastError());
}

const char* bin_cull_compact_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
