"""Inputs and the reference path for the tests of binning's fused cull and
compaction (render/cull.py), shared by the CPU tests and the card's.
Imports neither JAX nor the JAX package."""

import math

import torch

from robosimgs_tpu_torch.render.binning import _bbox_slots, _cull_keep
from robosimgs_tpu_torch.render.tiles import num_tiles, tile_bbox


def cull_inputs(seed, n=700, W=160, H=112, ts=16, device="cpu"):
    """Synthetic depth-ordered bbox rows [mx, my, radius, a, b, c, op]
    with their tile bboxes, (bbox, (tx0, ty0, tx1, ty1), tiles_x, T):
    splats across and past the image border, bboxes of up to 8 x 8
    tiles, a seventh invalid (radius 0), some with a conic that is not
    PSD (a < 0, c = 0 or NaN) or an opacity under the clamp."""
    g = torch.Generator().manual_seed(seed)

    def u(lo, hi):
        return torch.rand(n, generator=g) * (hi - lo) + lo

    mx, my = u(-30, W + 30), u(-30, H + 30)
    s1, s2, th = u(0.5, 22), u(0.2, 1.0), u(0, math.pi)
    s2 = s1 * s2
    ct, st = torch.cos(th), torch.sin(th)
    cxx = ct * ct * s1 * s1 + st * st * s2 * s2
    cyy = st * st * s1 * s1 + ct * ct * s2 * s2
    cxy = ct * st * (s1 * s1 - s2 * s2)
    det = cxx * cyy - cxy * cxy
    a, b, c = cyy / det, -cxy / det, cxx / det
    radius = torch.ceil(3.0 * s1)
    radius[::7] = 0.0
    a[3::13] = -a[3::13]
    c[5::17] = 0.0
    b[6::19] = float("nan")
    c[6::19] = float("nan")
    op = u(0.002, 1.0)
    op[4::11] = 1e-13
    bbox = torch.stack([mx, my, radius, a, b, c, op], dim=1).to(device)
    tiles_x, tiles_y = num_tiles(W, H, ts)
    edges = tile_bbox(bbox[:, 0:2], bbox[:, 2], tiles_x, tiles_y, ts)
    return bbox, edges, tiles_x, tiles_x * tiles_y


def row_sort_path(bbox, edges, tiles_x, T, Mb, M, exact, ts=16,
                  alpha_min=1.0 / 255.0, sort=True):
    """binning's steps before the fused kernel: every slot of the bbox
    enumerated, culled, the culled ones set to T, each row sorted and cut
    to M (with sort False, the holes left where they are and the row not
    cut, as binning did for Mb = M in one tier). (tid, surv, cover)."""
    tx0, ty0, _, _ = edges
    tid, row, col, in_bbox, cover = _bbox_slots(*edges, Mb, tiles_x)
    valid_e = in_bbox & (bbox[:, 2] > 0.0)[:, None]
    if exact:
        valid_e = valid_e & _cull_keep(bbox[:, 0:2], bbox[:, 3:7], tx0, ty0,
                                       col, row, ts, alpha_min)
    tid = torch.where(valid_e, tid, torch.full_like(tid, T))
    if sort:
        tid = torch.sort(tid, dim=1).values[:, :M]
    return tid, valid_e.sum(dim=1), cover
