"""Binning's exact tile cull and row compaction: Hopper kernel + plain torch.

`bin_cull_compact` takes each depth-ordered Gaussian's bbox row, its
cull cut and its inclusive tile bbox, and gives

  (tid (n, M) int64, surv (n,) int64, cover (n,) int64):

the tile ids of the first Mb bbox slots (row-major) that the Gaussian
may reach, in enumeration order, then the sentinel n_tiles to the end of
the row; the kept slots among all Mb (those past M included); the bbox's
tile count. On a CUDA tensor it launches csrc/bin_cull_compact.cu, a
kernel written for this card that replaces no TPU kernel (the JAX package
bins in XLA): one warp a Gaussian, a ballot giving each kept slot its
column, no (n, Mb) temporaries and no sort. On a CPU tensor it runs
`bin_cull_compact_plain`, the port's torch code for the same step: every
slot enumerated and culled as an (n, Mb) grid, then a row sort. The two
agree bit for bit on the card; csrc/ has the kernel's bound and design.

The enumeration and the exact cull are tiles.py's (`_bbox_slots`,
`_cull_keep`): a culled tile has alpha < alpha_min at every pixel, so the
compositor's keep-mask would zero it anyway.
"""

from __future__ import annotations

import ctypes

import torch

from robosimgs_tpu_torch.render import _build
from robosimgs_tpu_torch.render.tiles import _bbox_slots, _cull_keep_q


def _check_inputs(bbox, qcut, edges, n_slots: int, max_tiles: int,
                  tile_size: int) -> None:
    if bbox.dim() != 2 or bbox.shape[1] != 7 or bbox.dtype != torch.float32:
        raise ValueError(f"bbox must be (n, 7) float32, got "
                         f"{tuple(bbox.shape)} {bbox.dtype}")
    n = bbox.shape[0]
    named = [("bbox", bbox, torch.float32)] + [
        (k, x, torch.int64) for k, x in zip(("tx0", "ty0", "tx1", "ty1"),
                                            edges)]
    if qcut is not None:
        named.append(("qcut", qcut, torch.float32))
    for name, x, dtype in named:
        if x.dtype != dtype or (name != "bbox" and tuple(x.shape) != (n,)):
            raise ValueError(f"{name} must be ({n},) {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device != bbox.device:
            raise ValueError(f"{name} on {x.device}, bbox on {bbox.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= max_tiles <= n_slots or tile_size < 1:
        raise ValueError(f"needs 1 <= max_tiles ({max_tiles}) <= n_slots "
                         f"({n_slots}) and tile_size ({tile_size}) >= 1")
    if n >= 2 ** 31 or n_slots >= 2 ** 31:
        raise ValueError(f"{n} Gaussians x {n_slots} slots: the kernel "
                         f"indexes both with 32-bit ints")


_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    """The loaded library of csrc/bin_cull_compact.cu, its functions
    typed."""
    lib = _build.load("bin_cull_compact")
    fn = lib.bin_cull_compact_launch
    if fn.argtypes is None:
        lib.bin_cull_compact_error_string.argtypes = [ctypes.c_int]
        lib.bin_cull_compact_error_string.restype = ctypes.c_char_p
        fn.restype = ctypes.c_int
        # 9 tensors, n / n_slots / max_tiles, tiles_x / n_tiles, tile_size,
        # the stream
        fn.argtypes = [_PTR] * 9 + [_I32] * 3 + [_I64] * 2 + [_I32, _PTR]
    return lib


def bin_cull_compact(bbox: torch.Tensor, qcut: torch.Tensor | None,
                     tx0: torch.Tensor, ty0: torch.Tensor, tx1: torch.Tensor,
                     ty1: torch.Tensor, *, tiles_x: int, n_tiles: int,
                     n_slots: int, max_tiles: int, tile_size: int):
    """(tid (n, max_tiles), surv (n,), cover (n,)), all int64, for n
    depth-ordered Gaussians.

    bbox (n, 7) float32 rows [mx, my, radius, conic a, b, c, opacity]
    (a slot is kept only where radius > 0); qcut (n,) float32, each
    Gaussian's `cull_qcut`, or None to keep every bbox slot (no exact
    cull); tx0, ty0, tx1, ty1 (n,) int64, the inclusive tile bbox
    (`tiles.tile_bbox`, so inside the grid of tiles_x columns and
    n_tiles tiles). The first n_slots slots of the bbox are enumerated
    row-major and culled; row i of tid holds the kept ones' tile ids in
    that order, then n_tiles (the sentinel); surv counts the kept slots
    among all n_slots, cover the bbox's tiles.

    The CUDA kernel for CUDA tensors, `bin_cull_compact_plain` for CPU
    tensors. `bin_cull_compact.launches` counts kernel launches."""
    edges = (tx0, ty0, tx1, ty1)
    _check_inputs(bbox, qcut, edges, n_slots, max_tiles, tile_size)
    kw = dict(tiles_x=tiles_x, n_tiles=n_tiles, n_slots=n_slots,
              max_tiles=max_tiles, tile_size=tile_size)
    if bbox.device.type == "cpu":
        return bin_cull_compact_plain(bbox, qcut, *edges, **kw)
    if bbox.device.type != "cuda":
        raise ValueError(f"bin_cull_compact runs on cuda or cpu, not "
                         f"{bbox.device}")
    n, dev = bbox.shape[0], bbox.device
    tid = torch.empty((n, max_tiles), dtype=torch.int64, device=dev)
    surv = torch.empty((n,), dtype=torch.int64, device=dev)
    cover = torch.empty((n,), dtype=torch.int64, device=dev)
    if n == 0:
        return tid, surv, cover
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.bin_cull_compact_launch(
            bbox.data_ptr(), None if qcut is None else qcut.data_ptr(),
            *(x.data_ptr() for x in edges), tid.data_ptr(), surv.data_ptr(),
            cover.data_ptr(), n, n_slots, max_tiles, tiles_x, n_tiles,
            tile_size, stream)
    if rc != 0:
        msg = lib.bin_cull_compact_error_string(rc).decode()
        raise RuntimeError(f"bin_cull_compact launch failed: {msg} ({rc})")
    bin_cull_compact.launches += 1
    return tid, surv, cover


bin_cull_compact.launches = 0


def bin_cull_compact_plain(bbox: torch.Tensor, qcut: torch.Tensor | None,
                           tx0: torch.Tensor, ty0: torch.Tensor,
                           tx1: torch.Tensor, ty1: torch.Tensor, *,
                           tiles_x: int, n_tiles: int, n_slots: int,
                           max_tiles: int, tile_size: int):
    """`bin_cull_compact` in plain torch: the (n, n_slots) slot grid
    enumerated (`_bbox_slots`), culled (`_cull_keep_q`), the culled slots
    set to the sentinel, and each row sorted. A bbox inside the grid
    enumerates rising tile ids and the sentinel exceeds them all, so the
    sort keeps the survivors' order and moves the sentinels to the
    tail."""
    tid, row, col, keep, cover = _bbox_slots(tx0, ty0, tx1, ty1, n_slots,
                                             tiles_x)
    keep = keep & (bbox[:, 2] > 0.0)[:, None]
    if qcut is not None:
        keep = keep & _cull_keep_q(bbox[:, 0:2], bbox[:, 3:6], qcut[:, None],
                                   tx0, ty0, col, row, tile_size)
    tid = torch.where(keep, tid, torch.full_like(tid, n_tiles))
    tid = torch.sort(tid, dim=1).values[:, :max_tiles]
    return tid, keep.sum(dim=1), cover
