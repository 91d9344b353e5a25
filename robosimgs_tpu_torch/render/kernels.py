"""Per-tile compositing, forward and backward: Hopper kernels + plain torch.

`composite_fwd` replaces robosimgs_tpu/render/pallas_kernels.py::
_fwd_kernel (entry composite_fwd_pallas) with the hand-written CUDA
kernel in csrc/composite_fwd.cu, with the same inputs and outputs:

  (T,8,K) geom/feat + (T,) counts + (T,P,1) depth limits ->
  (out (T,8,P), log_t_final (T,P,1), nblk (T,) int32,
   log_t_groups (T,K/16,P))

`composite_bwd` replaces _bwd_kernel (entry composite_bwd_pallas) with
csrc/composite_bwd.cu: one back-to-front sweep per tile from the
forward's residuals,

  forward inputs + gout (T,8,P) + log_t_final + nblk + log_t_groups ->
  (dgeom (T,8,K), dfeat (T,8,K))

nblk counts the 128-splat blocks a tile processed before all of its
pixels saturated, and log_t_final sums log1p(-alpha) over every kept
splat of those blocks (the first three outputs are the Pallas kernel's).
log_t_groups, which the Pallas pair does not have, holds each processed
block's running sum at the end of every 16-slot group (the kernel leaves
the entries past the processed blocks unwritten, the plain version 0);
the backward rebuilds each splat's transmittance from these in log space
without evaluating an alpha twice. `Composite` joins the pair into one
autograd op (the counterpart of the JAX package's custom_vjp in
render/tiled.py).

What bounds both kernels on an H100: per evaluated (pixel, splat) pair
about 17 FP32 operations (one of them an SFU exp), and per pair that
adds weight about 22 more in the forward (a log1p, 8 channel FMAs) and
about 74 more in the backward (the gate, gamma's 8 FMAs, 14 products
summed over the tile), against 64 B of geom/feat per splat shared by the
tile's pixels — operations at 16x16, while at 32x32 and a deep capacity
the backward's 64 B written per slot bound it. Both stage each splat
block once into shared memory by cp.async, one block ahead, and keep
every per-pixel value in registers; the forward evaluates 8 alphas ahead
of its serial transmittance update, and the backward evaluates each
alpha once and skips, exactly, the slots no pixel of a warp keeps and
the groups every pixel of a warp enters saturated. On tiles over 16x16
(or not in whole warps) both kernels run a tile as one thread-block
cluster: the forward splits the tile's pixel rows into the bands of
`fwd_bands` (one block each, one stop vote for the tile through
distributed shared memory) and walks only the slots some pixel of a
warp's or a band's box may keep (`fwd_skip_grain`; `footprint_misses`
is the test in torch), the backward splits its processed blocks
across `bwd_splits` blocks, which pass each other the suffix they carry
in, and launches the deepest tiles first. Not yet done: TMA staging,
tensor-core forms of the backward's sums over pixels; the csrc/ sources
have the details.

On a CPU tensor each wrapper runs its plain torch version
(`composite_fwd_plain`, `composite_bwd_plain`); on a CUDA tensor it
launches the kernel or raises. Both kernels take tiles of up to 32x32
pixels, any count P <= 1024 (whole warps up to 16x16 one block a tile,
everything else as a cluster).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from robosimgs_tpu_torch.render import _build
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.gathered import (tile_alpha, tile_alpha_parts,
                                                 tile_pixel_coords)
from robosimgs_tpu_torch.utils.profiling import span

# splats per block: the unit of the early exit and of nblk (Pallas BK)
BK = 128
# slots per log_t_groups entry (csrc/composite_common.cuh LT_GROUP; each
# kernel library reports its own, checked when it is loaded)
LT_GROUP = 16
# tiles per pass of the plain versions: bounds their (tiles, P, BK)
# temporaries
_PLAIN_TILE_CHUNK = 128
# the most blocks the backward splits a tile across (one thread-block
# cluster of the portable size; csrc/composite_bwd.cu MAX_SPLITS)
MAX_SPLITS = 8


# pixels (threads) of one forward block
FWD_THREADS = 256
# the forward's skip grains (csrc/composite_fwd.cu SKIP_NONE, SKIP_WARP,
# SKIP_BAND)
_GRAINS = {"none": 0, "warp": 1, "band": 2}


def _split_kernel(P: int) -> bool:
    """Whether both kernels run a tile of P pixels as a thread-block
    cluster (the backward through its split kernel): all but whole warps
    up to 16x16."""
    return P % 32 != 0 or P > 256


def fwd_bands(tile_size: int) -> list[tuple[int, int]]:
    """The forward kernel's blocks for one tile: [(row0, row1), ...], the
    tile's pixel rows that block rank r composites, one block a tile for
    whole warps up to 16x16, else S = ceil(ts / (256 // ts)) blocks of
    one cluster (ceil(P / 256) for every tile up to 32x32),
    rank r taking rows [r ts / S, (r + 1) ts / S): at most 256 pixels a
    band. The mirror of csrc/composite_fwd.cu's rule, which the launcher
    applies itself."""
    ts = tile_size
    if ts < 1 or ts * ts > 1024:
        raise ValueError(f"tile_size {ts}: the forward takes 1..32")
    if not _split_kernel(ts * ts):
        return [(0, ts)]
    n = -(-ts // (FWD_THREADS // ts))
    return [(r * ts // n, (r + 1) * ts // n) for r in range(n)]


def fwd_skip_grain(n_tiles: int, tile_size: int, n_sms: int) -> str | None:
    """Which pixels the forward's cluster instance tests a batch's slots
    for before it walks them: "warp" (each warp for its own pixels) where
    every block of the launch is resident at once, two a SM (n_tiles x
    S <= 2 n_sms: each warp's chain of slots sets the time, and a warp's
    row skips the most), else "band" (each block once for its band: the
    launch runs in waves, so the test's own work counts). None for tiles
    of whole warps up to 16x16 (one block a tile, no skip).

    Measured by tools/fwd_grains.py on an NVIDIA H100 80GB HBM3 at 700 W
    (132 SMs, 32x32 tiles, PERF.md): on the 3M view cut to T = 64, 96,
    ..., 256 tiles, "warp" was the faster at T 64 and "band" at every T
    from 96, so the switch lies between 256 and 384 blocks, where this
    rule puts it (264). On the bench view batched to T = 64 ... 256,
    "warp" was the faster at every T: there the rule's "band" past T 66
    costs 13-30 % against "warp" (still faster than no skip). Which grain
    wins past one wave depends on the splats, which the launch does not
    see."""
    if not _split_kernel(tile_size * tile_size):
        return None
    fits = n_tiles * len(fwd_bands(tile_size)) <= 2 * n_sms
    return "warp" if fits else "band"


def fwd_skip_groups(tile_size: int, grain: str) -> list[tuple[int, int]]:
    """The pixel groups whose box the cluster instance tests for its skip,
    as tile pixel ranges [(p0, p1), ...]: "warp", the warps, 32
    consecutive pixels of a band each (the last of a band may hold
    fewer); "band", each block's band of `fwd_bands`."""
    ts = tile_size
    if grain == "warp":
        return [(w, min(w + 32, r1 * ts)) for r0, r1 in fwd_bands(ts)
                for w in range(r0 * ts, r1 * ts, 32)]
    return [(r0 * ts, r1 * ts) for r0, r1 in fwd_bands(ts)]


def footprint_misses(geom: torch.Tensor, *, tiles_x: int, cfg: RenderConfig,
                     grain: str, n_tiles_per_image: int = 0,
                     t_idx: torch.Tensor | None = None) -> torch.Tensor:
    """(T, G, K) bool: the cluster instance's footprint test
    (csrc/composite_fwd.cu::misses) in plain torch, for each pixel group
    of `fwd_skip_groups` and slot: True where the group skips the slot
    because no pixel center of the box its pixels span (their rows, and
    the columns of one row or the tile's width) can keep the splat. q's
    least value on the box lies on its boundary (each edge's vertex
    clamped to the edge), or is 0 where the mean lies inside; a slot is
    skipped only where it exceeds ln(op / alpha_min) by 2e-6 of the
    largest sum of |terms| of q over the box plus 1e-5 (1 + |ln(op /
    alpha_min)|), and never where a <= 0, c <= 0, op <= 0 or anything is
    not finite. t_idx (T,) overrides each row's within-image tile index
    (else t % n_tiles_per_image). Used by tests and chip_smoke.py (the
    share of pairs skipped); the kernel runs its own."""
    T, _, K = geom.shape
    ts = cfg.tile_size
    dev = geom.device
    groups = torch.tensor(fwd_skip_groups(ts, grain), device=dev)   # (G, 2)
    tl = t_idx if t_idx is not None else (
        torch.arange(T, device=dev) % (n_tiles_per_image or max(T, 1)))
    tx0 = ((tl % tiles_x) * ts)[:, None]
    ty0 = ((tl // tiles_x) * ts)[:, None]
    r0, r1 = groups[:, 0] // ts, (groups[:, 1] - 1) // ts      # (G,)
    one = r0 == r1
    c0 = torch.where(one, groups[:, 0] % ts, 0)
    c1 = torch.where(one, (groups[:, 1] - 1) % ts, ts - 1)
    mx, my, a, b, c, op = (geom[:, i, None, :] for i in range(6))
    dx0 = (tx0 + c0).float()[:, :, None] - mx                 # (T, G, K)
    dx1 = (tx0 + c1).float()[:, :, None] - mx
    dy0 = (ty0 + r0).float()[:, :, None] - my
    dy1 = (ty0 + r1).float()[:, :, None] - my

    def q(dx, dy):
        return 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy

    def on_row(dy):
        return q(torch.minimum(torch.maximum(-b * dy / a, dx0), dx1), dy)

    def on_col(dx):
        return q(dx, torch.minimum(torch.maximum(-b * dx / c, dy0), dy1))

    q_min = torch.minimum(torch.minimum(on_row(dy0), on_row(dy1)),
                          torch.minimum(on_col(dx0), on_col(dx1)))
    inside = (dx0 <= 0) & (dx1 >= 0) & (dy0 <= 0) & (dy1 >= 0)
    q_min = torch.where(inside, torch.clamp_max(q_min, 0.0), q_min)
    dxm = torch.maximum(dx0.abs(), dx1.abs())
    dym = torch.maximum(dy0.abs(), dy1.abs())
    terms = 0.5 * (a * dxm * dxm + c * dym * dym) + b.abs() * dxm * dym
    thr = torch.log(op) - math.log(cfg.alpha_min)
    margin = 2e-6 * terms + 1e-5 * (1.0 + thr.abs())
    finite = ((a > 0) & (c > 0) & (op > 0) & torch.isfinite(mx)
              & torch.isfinite(my) & torch.isfinite(a) & torch.isfinite(b)
              & torch.isfinite(c) & torch.isfinite(op))
    return (finite & torch.isfinite(q_min) & torch.isfinite(margin)
            & torch.isfinite(thr) & (q_min - margin > thr))


def bwd_splits(n_tiles: int, K: int, P: int, n_sms: int) -> int:
    """Blocks per tile of the backward kernel: 1 for tiles of whole warps
    up to 16x16 (one block a tile), else the most that keeps n_tiles x
    splits within 2 n_sms, at most one per processed block of a full tile
    (K / BK) and MAX_SPLITS. The split kernel holds one block per SM and
    launches the deepest tiles first, so a second wave of short ranges
    fills in behind the long ones; more splits than that add work (each
    range but the first is walked once more for its suffix sums). On the
    card this rule picked the fastest count measured at 64 and at 256
    tiles (PERF.md). From the shapes alone: how many blocks a tile
    processed (nblk) stays on the device."""
    if not _split_kernel(P):
        return 1
    return max(1, min(K // BK, MAX_SPLITS, 2 * n_sms // max(n_tiles, 1)))


def split_range(nb: int, rank: int, splits: int) -> tuple[int, int]:
    """[lo, hi): the processed blocks that block `rank` of a tile's
    `splits` sweeps when the tile processed nb (the kernel's own rule)."""
    return rank * nb // splits, (rank + 1) * nb // splits


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_chunking(cfg: RenderConfig, CK: int) -> None:
    """tile_chunk validation, as the JAX package's `_chunking`
    (pallas_kernels.py). The CUDA kernels stream the whole capacity, so
    the chunking only has to be valid."""
    kc = cfg.tile_chunk or CK
    if kc % BK != 0:
        raise ValueError(f"tile_chunk {kc} must be a multiple of {BK}")
    if CK % kc != 0:
        raise ValueError(f"tile_capacity {CK} must be a multiple of "
                         f"tile_chunk {kc}")


def _check(x: torch.Tensor, name: str, shape: tuple, dtype: torch.dtype,
           device: torch.device) -> None:
    if tuple(x.shape) != shape or x.dtype != dtype:
        raise ValueError(f"{name} must be {shape} {dtype}, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device != device:
        raise ValueError(f"{name} on {x.device}, geom on {device}")
    if not x.is_contiguous():
        raise ValueError("inputs must be contiguous")


def _check_inputs(geom, feat, counts, dlim, cfg, has_dlim):
    if geom.dim() != 3 or geom.shape[1] != 8:
        raise ValueError(f"geom must be (T, 8, K), got {tuple(geom.shape)}")
    T, _, K = geom.shape
    P = cfg.tile_size * cfg.tile_size
    _check_chunking(cfg, K)
    if P > 1024:
        raise ValueError(f"tile_size {cfg.tile_size}: {P} pixels exceed the "
                         f"1024 threads of one block")
    dev = geom.device
    _check(geom, "geom", (T, 8, K), torch.float32, dev)
    _check(feat, "feat", (T, 8, K), torch.float32, dev)
    _check(counts, "counts", (T,), torch.int32, dev)
    if has_dlim:
        if dlim is None:
            raise ValueError(f"dlim must be ({T}, {P}, 1) with has_dlim")
        _check(dlim, "dlim", (T, P, 1), torch.float32, dev)


_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C signatures of csrc/*.cu's launch functions: tensors (the
# backward's with the launch order of the tiles, the forward's with its
# pair counters), the int shapes (the forward's with its skip grain), the
# 3 RenderConfig thresholds, (backward) absgrad and the splits a tile,
# the stream
_ARGTYPES = {
    "composite_fwd": [_PTR] * 9 + [_I32] * 6 + [_F32] * 3 + [_PTR],
    "composite_bwd": [_PTR] * 11 + [_I32] * 5 + [_F32] * 3 + [_I32] * 2
    + [_PTR],
}


def _lib(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, its functions typed, after
    checking that it lays out log_t_groups as this module does."""
    lib = _build.load(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        lt_group = getattr(lib, f"{name}_lt_group")
        lt_group.argtypes, lt_group.restype = [], ctypes.c_int
        if lt_group() != LT_GROUP:
            raise RuntimeError(f"{name} was built with {lt_group()} slots per "
                               f"log_t_groups entry, this module has "
                               f"{LT_GROUP}")
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name]
    return lib


def _check_aligned(geom: torch.Tensor, feat: torch.Tensor, name: str) -> None:
    """The kernels stage geom/feat 16 bytes a copy."""
    if geom.data_ptr() % 16 or feat.data_ptr() % 16:
        raise ValueError(f"{name} needs geom and feat 16-byte aligned")


def _raise_on(lib: ctypes.CDLL, name: str, rc: int) -> None:
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")


def composite_fwd(geom: torch.Tensor, feat: torch.Tensor,
                  counts: torch.Tensor, dlim: torch.Tensor | None, *,
                  tiles_x: int, cfg: RenderConfig, n_tiles_per_image: int = 0,
                  has_dlim: bool = True, skip: str | None = None,
                  pairs: torch.Tensor | None = None):
    """(T,8,K) geom/feat + (T,) int32 counts + (T,P,1) dlim ->
    (out (T,8,P), log_t_final (T,P,1), nblk (T,) int32,
    log_t_groups (T,K/16,P)).

    The CUDA kernel for CUDA tensors, `composite_fwd_plain` for CPU
    tensors. dlim may be None when has_dlim is False. n_tiles_per_image:
    tile t takes the pixel coordinates of tile t % n_tiles_per_image
    (multi-camera batches concatenated on the tile axis; 0 = T).
    Records no autograd graph of its own: `Composite` is the
    differentiable form. `composite_fwd.launches` counts kernel launches.

    For measurement and tests: skip forces the slots the kernel walks,
    "none" (every slot), or on tiles that run as a cluster "warp" or
    "band" (None: `fwd_skip_grain`); every choice gives the same bits.
    pairs, a (2,) int64 tensor on the card, gets the (pixel, slot) pairs
    the cluster instance walked and those of the batches it processed
    added to it (tiles over 16x16 or not in whole warps, CUDA tensors
    only: the one-block instance and the plain version count none)."""
    _check_inputs(geom, feat, counts, dlim, cfg, has_dlim)
    cluster = _split_kernel(cfg.tile_size * cfg.tile_size)
    if skip not in (None, "none") and (skip not in _GRAINS or not cluster):
        raise ValueError(f"skip {skip!r}: 'none', or 'warp' or 'band' on "
                         f"tiles over 16x16 or not in whole warps")
    if pairs is not None and (pairs.shape != (2,) or pairs.dtype != torch.int64
                              or pairs.device != geom.device
                              or geom.device.type != "cuda" or not cluster):
        raise ValueError("pairs must be a (2,) int64 tensor on geom's CUDA "
                         "device, and the tiles run as a cluster")
    if geom.device.type == "cpu":
        return composite_fwd_plain(geom, feat, counts, dlim, tiles_x=tiles_x,
                                   cfg=cfg, n_tiles_per_image=n_tiles_per_image,
                                   has_dlim=has_dlim)
    if geom.device.type != "cuda":
        raise ValueError(f"composite_fwd runs on cuda or cpu, not {geom.device}")
    _check_aligned(geom, feat, "composite_fwd")
    T, _, K = geom.shape
    P = cfg.tile_size * cfg.tile_size
    out = torch.empty((T, 8, P), dtype=torch.float32, device=geom.device)
    log_t_final = torch.empty((T, P, 1), dtype=torch.float32, device=geom.device)
    nblk = torch.empty((T,), dtype=torch.int32, device=geom.device)
    log_t_groups = torch.empty((T, K // LT_GROUP, P), dtype=torch.float32,
                               device=geom.device)
    if T == 0:
        return out, log_t_final, nblk, log_t_groups
    lib = _lib("composite_fwd")
    stream = torch.cuda.current_stream(geom.device).cuda_stream
    grain = skip or fwd_skip_grain(T, cfg.tile_size, _sm_count(geom.device))
    with torch.cuda.device(geom.device):
        rc = lib.composite_fwd_launch(
            geom.data_ptr(), feat.data_ptr(), counts.data_ptr(),
            dlim.data_ptr() if has_dlim else None,
            out.data_ptr(), log_t_final.data_ptr(), log_t_groups.data_ptr(),
            nblk.data_ptr(), None if pairs is None else pairs.data_ptr(),
            T, K, tiles_x, n_tiles_per_image or T, cfg.tile_size,
            _GRAINS[grain or "none"], cfg.alpha_clamp, cfg.alpha_min,
            cfg.transmittance_min, stream)
    _raise_on(lib, "composite_fwd", rc)
    composite_fwd.launches += 1
    return out, log_t_final, nblk, log_t_groups


composite_fwd.launches = 0


def composite_fwd_plain(geom: torch.Tensor, feat: torch.Tensor,
                        counts: torch.Tensor, dlim: torch.Tensor | None, *,
                        tiles_x: int, cfg: RenderConfig,
                        n_tiles_per_image: int = 0, has_dlim: bool = True):
    """`composite_fwd` in plain torch, block by block like the Pallas
    kernel: within a 128-splat block T_k = T_block * exp(exclusive
    cumsum of log1p(-alpha)); a tile stops before the first block where
    its count is exhausted or no pixel has T >= transmittance_min.
    log_t_final adds each block's sum once, the grouping
    `composite_bwd_plain` takes back; log_t_groups holds the inclusive
    cumsum at each 16-slot group end of the processed blocks, 0 past
    them."""
    T, _, K = geom.shape
    ts = cfg.tile_size
    P = ts * ts
    dev = geom.device
    t_img = torch.arange(T, device=dev) % (n_tiles_per_image or max(T, 1))
    cnt_all = counts.long().clamp(0, K)
    out = geom.new_zeros((T, 8, P))
    log_t_final = geom.new_zeros((T, P, 1))
    nblk = torch.zeros((T,), dtype=torch.int32, device=dev)
    log_t_groups = geom.new_zeros((T, K // LT_GROUP, P))
    for s in range(0, T, _PLAIN_TILE_CHUNK):
        e = min(s + _PLAIN_TILE_CHUNK, T)
        px, py = tile_pixel_coords(t_img[s:e], tiles_x, ts)
        cnt = cnt_all[s:e]
        acc = geom.new_zeros((e - s, 8, P))
        tc = geom.new_ones((e - s, P))
        ltc = geom.new_zeros((e - s, P))
        nb = torch.zeros((e - s,), dtype=torch.int32, device=dev)
        live = torch.ones((e - s,), dtype=torch.bool, device=dev)
        for off in range(0, K, BK):
            live = live & (off < cnt) & (tc.amax(dim=1) >= cfg.transmittance_min)
            if not bool(live.any()):
                break
            g = geom[s:e, :, off:off + BK]
            f = feat[s:e, :, off:off + BK]
            in_count = (off + torch.arange(BK, device=dev))[None, :] < cnt[:, None]
            alpha = tile_alpha(g, px, py, in_count, cfg,
                               dlim[s:e, :, 0] if has_dlim else None)
            lg = torch.log1p(-alpha)
            incl = torch.cumsum(lg, dim=2)
            Tk = tc[:, :, None] * torch.exp(incl - lg)
            w = alpha * Tk * (Tk * (1.0 - alpha) >= cfg.transmittance_min)
            lv = live[:, None]
            acc = acc + torch.where(lv[:, :, None],
                                    torch.einsum("nck,npk->ncp", f, w),
                                    torch.zeros_like(acc))
            tc = torch.where(lv, tc * torch.exp(incl[:, :, -1]), tc)
            ltc = torch.where(lv, ltc + incl[:, :, -1], ltc)
            ends = incl[:, :, LT_GROUP - 1::LT_GROUP].transpose(1, 2)
            gs = slice(off // LT_GROUP, (off + BK) // LT_GROUP)
            log_t_groups[s:e, gs] = torch.where(lv[:, :, None], ends, 0.0)
            nb = nb + live.to(torch.int32)
        out[s:e] = acc
        log_t_final[s:e, :, 0] = ltc
        nblk[s:e] = nb
    return out, log_t_final, nblk, log_t_groups


def _check_bwd_inputs(geom, feat, counts, dlim, gout, log_t_final, nblk,
                      log_t_groups, cfg, has_dlim):
    _check_inputs(geom, feat, counts, dlim, cfg, has_dlim)
    T, _, K = geom.shape
    P = cfg.tile_size * cfg.tile_size
    dev = geom.device
    _check(gout, "gout", (T, 8, P), torch.float32, dev)
    _check(log_t_final, "log_t_final", (T, P, 1), torch.float32, dev)
    _check(nblk, "nblk", (T,), torch.int32, dev)
    if log_t_groups is not None:
        _check(log_t_groups, "log_t_groups", (T, K // LT_GROUP, P),
               torch.float32, dev)


def composite_bwd(geom: torch.Tensor, feat: torch.Tensor,
                  counts: torch.Tensor, dlim: torch.Tensor | None,
                  gout: torch.Tensor, log_t_final: torch.Tensor,
                  nblk: torch.Tensor, log_t_groups: torch.Tensor | None, *,
                  tiles_x: int, cfg: RenderConfig, n_tiles_per_image: int = 0,
                  has_dlim: bool = True):
    """The backward of `composite_fwd`: its inputs, the cotangent gout
    (T,8,P) of its output and its residuals (log_t_final, nblk,
    log_t_groups) -> (dgeom (T,8,K), dfeat (T,8,K)).

    dgeom rows: d mx, d my, d conic a/b/c, d opacity, 0 (depth is not
    differentiated), and with cfg.absgrad the summed |d mx| per pixel;
    dfeat: gout . w per channel, row 7 the summed |d my| under absgrad.
    Slots outside the processed blocks are 0. The CUDA kernel for CUDA
    tensors, which needs log_t_groups; `composite_bwd_plain` for CPU
    tensors, where log_t_groups may be None (residuals of a forward that
    has none, such as the Pallas kernel's). `composite_bwd.launches`
    counts kernel launches."""
    _check_bwd_inputs(geom, feat, counts, dlim, gout, log_t_final, nblk,
                      log_t_groups, cfg, has_dlim)
    if geom.device.type == "cpu":
        return composite_bwd_plain(geom, feat, counts, dlim, gout,
                                   log_t_final, nblk, log_t_groups,
                                   tiles_x=tiles_x, cfg=cfg,
                                   n_tiles_per_image=n_tiles_per_image,
                                   has_dlim=has_dlim)
    if geom.device.type != "cuda":
        raise ValueError(f"composite_bwd runs on cuda or cpu, not {geom.device}")
    if log_t_groups is None:
        raise ValueError("composite_bwd on the card needs the forward's "
                         "log_t_groups")
    _check_aligned(geom, feat, "composite_bwd")
    T, _, K = geom.shape
    dgeom = torch.empty((T, 8, K), dtype=torch.float32, device=geom.device)
    dfeat = torch.empty((T, 8, K), dtype=torch.float32, device=geom.device)
    if T == 0:
        return dgeom, dfeat
    lib = _lib("composite_bwd")
    P = cfg.tile_size ** 2
    splits = bwd_splits(T, K, P, _sm_count(geom.device))
    # the split kernel's launch order, deepest tiles first (on the device:
    # the host never reads nblk)
    order = (torch.argsort(nblk, descending=True, stable=True).to(torch.int32)
             if _split_kernel(P) else None)
    stream = torch.cuda.current_stream(geom.device).cuda_stream
    with torch.cuda.device(geom.device):
        rc = lib.composite_bwd_launch(
            geom.data_ptr(), feat.data_ptr(), counts.data_ptr(),
            dlim.data_ptr() if has_dlim else None, gout.data_ptr(),
            log_t_final.data_ptr(), log_t_groups.data_ptr(), nblk.data_ptr(),
            None if order is None else order.data_ptr(), dgeom.data_ptr(),
            dfeat.data_ptr(), T, K, tiles_x, n_tiles_per_image or T,
            cfg.tile_size, cfg.alpha_clamp, cfg.alpha_min,
            cfg.transmittance_min, int(cfg.absgrad), splits, stream)
    _raise_on(lib, "composite_bwd", rc)
    composite_bwd.launches += 1
    return dgeom, dfeat


composite_bwd.launches = 0


def composite_bwd_plain(geom: torch.Tensor, feat: torch.Tensor,
                        counts: torch.Tensor, dlim: torch.Tensor | None,
                        gout: torch.Tensor, log_t_final: torch.Tensor,
                        nblk: torch.Tensor, log_t_groups: torch.Tensor | None,
                        *, tiles_x: int, cfg: RenderConfig,
                        n_tiles_per_image: int = 0, has_dlim: bool = True):
    """`composite_bwd` in plain torch, block by block like the Pallas
    kernel: the processed blocks in reverse; in each, inclusive cumsums
    of log1p(-alpha) and of gamma * w. The log-T entering a block is the
    carried log-T minus the block's sum, which the forward added once, so
    saturated pixels, whose log T sits near -350, keep their front
    splats' transmittance. The block's sum is the forward's own, its
    last log_t_groups entry, where log_t_groups is given, else the cumsum
    recomputed here (the same number when the plain forward made the
    residuals)."""
    T, _, K = geom.shape
    ts = cfg.tile_size
    P = ts * ts
    dev = geom.device
    t_min = cfg.transmittance_min
    t_img = torch.arange(T, device=dev) % (n_tiles_per_image or max(T, 1))
    cnt_all = counts.long().clamp(0, K)
    nb_all = nblk.long().clamp(0, K // BK)
    dgeom = geom.new_zeros((T, 8, K))
    dfeat = geom.new_zeros((T, 8, K))
    for s in range(0, T, _PLAIN_TILE_CHUNK):
        e = min(s + _PLAIN_TILE_CHUNK, T)
        n_blocks = int(nb_all[s:e].max()) if e > s else 0
        px, py = tile_pixel_coords(t_img[s:e], tiles_x, ts)
        cnt, nb, go = cnt_all[s:e], nb_all[s:e], gout[s:e]
        dl = dlim[s:e, :, 0] if has_dlim else None
        lte = log_t_final[s:e, :, 0]
        suf = geom.new_zeros((e - s, P))
        for i in range(n_blocks - 1, -1, -1):
            off = i * BK
            live = (nb > i)[:, None]
            g = geom[s:e, :, off:off + BK]
            f = feat[s:e, :, off:off + BK]
            in_count = (off + torch.arange(BK, device=dev))[None, :] < cnt[:, None]
            alpha, keep, raw, dx, dy = tile_alpha_parts(g, px, py, in_count,
                                                        cfg, dl)
            om = 1.0 - alpha
            lg = torch.log1p(-alpha)
            incl = torch.cumsum(lg, dim=2)
            block_sum = (incl[:, :, -1] if log_t_groups is None else
                         log_t_groups[s:e, (off + BK) // LT_GROUP - 1])
            lin = lte - block_sum                        # log T entering
            Tk = torch.exp(lin[:, :, None] + (incl - lg))
            m = Tk * om >= t_min
            w = alpha * Tk * m
            gamma = torch.einsum("ncp,nck->npk", go, f)
            gw = gamma * w
            incl_gw = torch.cumsum(gw, dim=2)
            suffix = suf[:, :, None] + (incl_gw[:, :, -1:] - incl_gw)
            dalpha = torch.where(m, gamma * Tk, 0.0) - suffix / om
            dalpha = torch.where(keep, dalpha, 0.0)
            dq = torch.where(raw < cfg.alpha_clamp, -alpha * dalpha, 0.0)
            ca, cb, cc = g[:, None, 2], g[:, None, 3], g[:, None, 4]
            ex = dq * (ca * dx + cb * dy)                # -(d mx) per pixel
            ey = dq * (cc * dy + cb * dx)
            zeros = torch.zeros_like(ex[:, 0])
            dgeom_b = torch.stack([
                -ex.sum(1), -ey.sum(1),
                0.5 * (dq * dx * dx).sum(1), (dq * dx * dy).sum(1),
                0.5 * (dq * dy * dy).sum(1),
                -dq.sum(1) / g[:, 5].clamp_min(1e-30),
                zeros, ex.abs().sum(1) if cfg.absgrad else zeros], dim=1)
            dfeat_b = torch.einsum("ncp,npk->nck", go, w)
            if cfg.absgrad:
                dfeat_b[:, 7] = ey.abs().sum(1)
            dgeom[s:e, :, off:off + BK] = torch.where(live[:, :, None],
                                                      dgeom_b, 0.0)
            dfeat[s:e, :, off:off + BK] = torch.where(live[:, :, None],
                                                      dfeat_b, 0.0)
            suf = torch.where(live, suf + incl_gw[:, :, -1], suf)
            lte = torch.where(live, lin, lte)
    return dgeom, dfeat


class Composite(torch.autograd.Function):
    """`composite_fwd` with `composite_bwd` as its backward: (geom, feat)
    -> out (T,8,P), differentiable in geom and feat; counts and dlim get
    no gradient. The forward saves (geom, feat, counts, dlim,
    log_t_final, nblk, log_t_groups) for the backward.

        out = Composite.apply(geom, feat, counts, dlim, tiles_x, cfg,
                              n_tiles_per_image, has_dlim)
    """

    @staticmethod
    def forward(ctx, geom, feat, counts, dlim, tiles_x: int, cfg: RenderConfig,
                n_tiles_per_image: int = 0, has_dlim: bool = True):
        kw = dict(tiles_x=tiles_x, cfg=cfg,
                  n_tiles_per_image=n_tiles_per_image, has_dlim=has_dlim)
        out, log_t_final, nblk, log_t_groups = composite_fwd(
            geom, feat, counts, dlim, **kw)
        ctx.save_for_backward(geom, feat, counts, dlim, log_t_final, nblk,
                              log_t_groups)
        ctx.kw = kw
        return out

    @staticmethod
    @span("splat.composite")
    def backward(ctx, gout):
        geom, feat, counts, dlim, log_t_final, nblk, log_t_groups = \
            ctx.saved_tensors
        dgeom, dfeat = composite_bwd(geom, feat, counts, dlim,
                                     gout.contiguous(), log_t_final, nblk,
                                     log_t_groups, **ctx.kw)
        return dgeom, dfeat, None, None, None, None, None, None
