"""Plain 3D Gaussian splatting: EWA projection with SH colour, and
front-to-back compositing tile by tile.

Written from the 3DGS rasterizer's published semantics, as the
configuration states them, in plain torch and float32 (the package
turns TF32 off), with no binning capacities, kernels or caches:

  * camera transform, Sigma = R S S^T R^T, the perspective Jacobian with
    the projected centre clamped to 1.3x the half field of view, 2D
    covariance + 0.3 px^2 blur, its inverse (the conic), radius
    ceil(3 sqrt(lambda_max)), pixel centres at integer coordinates
    (u = fx x / z + cx - 0.5);
  * colour = max(0, SH(dir) + 0.5), dir from the camera to the mean;
  * a splat reaches the pixels of the tiles its radius square touches;
  * alpha = min(0.99, opacity exp(-q)), kept iff alpha >= 1/255, q >= 0
    and (with a depth limit) depth <= the pixel's limit; splats in
    global depth order (stable: ties by index); weight alpha T while
    T (1 - alpha) >= 1e-4, and nothing after the first that fails.

`composite` walks each tile's list front to back in chunks of slots and
returns the image, and, on request, the needed work: per pixel the
splats it keeps (alpha >= 1/255, T >= 1e-4 as it reaches them), and per
tile the splats that any of its pixels keeps.
"""

from __future__ import annotations

import contextlib
import math

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# The control: the reference with every product computed in TF32, each
# operand rounded to TF32's 10 mantissa bits (to nearest) as the tensor
# cores take it. Torch's TF32 switches alone leave many of these shapes
# in float32 (the library picks kernels without tensor cores for them),
# so the rounding is done here; the gradient passes through unchanged.
PRECISION = {"tf32": False}


def tf32(x: torch.Tensor) -> torch.Tensor:
    if not PRECISION["tf32"]:
        return x
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return x + (r - x.detach()) if x.requires_grad else r


@contextlib.contextmanager
def precision(tf32_products: bool):
    """Compute the reference's products in TF32 (the control) inside the
    block, with torch's own TF32 switches on too."""
    prev = (PRECISION["tf32"], torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    PRECISION["tf32"] = tf32_products
    torch.backends.cuda.matmul.allow_tf32 = tf32_products
    torch.backends.cudnn.allow_tf32 = tf32_products
    try:
        yield
    finally:
        (PRECISION["tf32"], torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b, in TF32 for the control."""
    return tf32(a) @ tf32(b)

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


def camera_tensors(cam: dict, device) -> dict:
    """w2c rotation and translation, intrinsics and origin as f32
    tensors on `device`, from the camera's numpy c2w."""
    c2w = torch.as_tensor(cam["c2w"], dtype=torch.float64)
    r = c2w[:3, :3].T
    t = -(r @ c2w[:3, 3])
    f32 = dict(dtype=torch.float32, device=device)
    return {"R": r.to(**f32), "t": t.to(**f32), "origin": c2w[:3, 3].to(**f32),
            "fx": float(cam["fx"]), "fy": float(cam["fy"]),
            "cx": float(cam["cx"]), "cy": float(cam["cy"]),
            "width": cam["width"], "height": cam["height"]}


def sh_basis(degree: int, d: torch.Tensor) -> torch.Tensor:
    """(N, (degree+1)^2) real SH basis of unit directions d (N, 3)."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    cols = [torch.full_like(x, C0)]
    if degree >= 1:
        cols += [-C1 * y, C1 * z, -C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        cols += [C2[0] * x * y, C2[1] * y * z, C2[2] * (2 * zz - xx - yy),
                 C2[3] * x * z, C2[4] * (xx - yy)]
    if degree >= 3:
        cols += [C3[0] * y * (3 * xx - yy), C3[1] * x * y * z,
                 C3[2] * y * (4 * zz - xx - yy),
                 C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                 C3[4] * x * (4 * zz - xx - yy), C3[5] * z * (xx - yy),
                 C3[6] * x * (xx - 3 * yy)]
    return torch.stack(cols, -1)


def project(params: dict, cam: dict, rc: dict) -> dict:
    """Screen-space splats of the Gaussians in `params` (raw: log-scales,
    logit-opacities, unnormalised quaternions) seen by camera `cam`
    (`camera_tensors`), under the render config `rc`. Differentiable in
    every float parameter."""
    means = params["means"]
    q = params["quats"]
    q = q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True), 1e-12)
    w, x, y, z = q.unbind(-1)
    rot = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)     # (N, 3, 3)
    m = mm(cam["R"], rot * torch.exp(params["log_scales"])[:, None, :])
    cov = mm(m, m.transpose(-1, -2))                          # camera frame
    p = mm(means, cam["R"].T) + cam["t"]
    tz = p[:, 2]
    in_front = tz > rc["near"]
    z = torch.where(in_front, tz, torch.ones_like(tz))
    tan_x = 0.5 * cam["width"] / cam["fx"]
    tan_y = 0.5 * cam["height"] / cam["fy"]
    cx_ = torch.clamp(p[:, 0] / z, -1.3 * tan_x, 1.3 * tan_x)
    cy_ = torch.clamp(p[:, 1] / z, -1.3 * tan_y, 1.3 * tan_y)
    zero = torch.zeros_like(z)
    jac = torch.stack([
        torch.stack([cam["fx"] / z, zero, -cam["fx"] * cx_ / z], -1),
        torch.stack([zero, cam["fy"] / z, -cam["fy"] * cy_ / z], -1)], -2)
    cov2 = mm(mm(jac, cov), jac.transpose(-1, -2))
    a = cov2[:, 0, 0] + rc["blur"]
    b = cov2[:, 0, 1]
    c = cov2[:, 1, 1] + rc["blur"]
    det = a * c - b * b
    invertible = det > 0
    det = torch.where(invertible, det, torch.ones_like(det))
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.0))
    radius = torch.ceil(rc["radius_factor"]
                        * torch.sqrt(torch.clamp_min(lam, 0.0)))
    u = cam["fx"] * p[:, 0] / z + cam["cx"] - 0.5
    v = cam["fy"] * p[:, 1] / z + cam["cy"] - 0.5
    on_screen = ((u + radius > 0) & (u - radius < cam["width"] - 1)
                 & (v + radius > 0) & (v - radius < cam["height"] - 1))
    valid = params["alive"] & in_front & invertible & on_screen
    d = means - cam["origin"]
    d = d / torch.clamp_min(torch.linalg.norm(d, dim=-1, keepdim=True), 1e-8)
    sh = torch.cat([params["sh_dc"][:, None, :], params["sh_rest"]], 1)
    degree = int(round(math.sqrt(sh.shape[1]))) - 1
    colours = torch.clamp_min(
        mm(sh_basis(degree, d)[:, None, :], sh)[:, 0, :] + 0.5, 0.0)
    return {"uv": torch.stack([u, v], -1),
            "conic": torch.stack([c / det, -b / det, a / det], -1),
            "opacity": torch.sigmoid(params["logit_opacities"]),
            "colour": colours, "depth": tz,
            "radius": torch.where(valid, radius, torch.zeros_like(radius)),
            "valid": valid}


def tile_lists(proj: dict, width: int, height: int, ts: int):
    """Each tile's splats in global depth order: (order (L,) splat
    indices grouped by tile, start (T + 1,) offsets). A splat is listed
    in every tile of the inclusive tile range its radius square
    touches."""
    dev = proj["uv"].device
    tiles_x, tiles_y = -(-width // ts), -(-height // ts)
    n = proj["uv"].shape[0]
    depth = torch.where(proj["valid"], proj["depth"].detach(),
                        torch.full_like(proj["depth"], math.inf))
    order = torch.argsort(depth, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=dev)
    r = proj["radius"].detach()
    uv = proj["uv"].detach()

    def span(x, hi):
        return torch.clamp(torch.floor(x / ts), 0, hi - 1).long()

    x0, x1 = span(uv[:, 0] - r, tiles_x), span(uv[:, 0] + r, tiles_x)
    y0, y1 = span(uv[:, 1] - r, tiles_y), span(uv[:, 1] + r, tiles_y)
    live = r > 0
    bw = torch.where(live, x1 - x0 + 1, torch.zeros_like(x0))
    cover = bw * (y1 - y0 + 1)
    ids = torch.repeat_interleave(torch.arange(n, device=dev), cover)
    first = torch.cumsum(cover, 0) - cover
    e = torch.arange(ids.shape[0], device=dev) - first[ids]
    row = torch.div(e, bw[ids], rounding_mode="floor")
    tile = (y0[ids] + row) * tiles_x + x0[ids] + (e - row * bw[ids])
    key = tile * n + rank[ids]
    key, perm = torch.sort(key)
    start = torch.searchsorted(
        key, torch.arange(tiles_x * tiles_y + 1, device=dev) * n)
    return ids[perm], start


def composite(proj: dict, width: int, height: int, rc: dict,
              depth_limit: torch.Tensor | None = None,
              grad_out: dict | None = None, count: bool = False,
              tile_block: int = 128, chunk: int = 256) -> dict:
    """Composite projected splats. Returns {"rgb" (H, W, 3) premultiplied
    (no background), "alpha" (H, W), "depth" (H, W) alpha-weighted}.

    grad_out: {"rgb", "alpha"} upstream gradients (H, W, ...); then each
    block of tiles is composited again with autograd and the gradients
    of `proj`'s float entries are returned under "grads" instead (the
    image is composited without autograd first). count: add "pairs"
    (H, W) int64 and "entries" (T,) int64, the needed work."""
    ts = rc["tile_size"]
    dev = proj["uv"].device
    tiles_x, tiles_y = -(-width // ts), -(-height // ts)
    n_tiles = tiles_x * tiles_y
    ids, start = tile_lists(proj, width, height, ts)
    lengths = start[1:] - start[:-1]
    tpix = torch.arange(ts * ts, device=dev)
    out_rgb = torch.zeros((n_tiles, ts * ts, 3), device=dev)
    out_a = torch.zeros((n_tiles, ts * ts), device=dev)
    out_d = torch.zeros((n_tiles, ts * ts), device=dev)
    pairs = torch.zeros((n_tiles, ts * ts), dtype=torch.int64, device=dev)
    entries = torch.zeros((n_tiles,), dtype=torch.int64, device=dev)
    dl_tiles = None
    if depth_limit is not None:
        dl = torch.full((tiles_y * ts, tiles_x * ts), math.inf, device=dev)
        dl[:height, :width] = depth_limit
        dl_tiles = dl.reshape(tiles_y, ts, tiles_x, ts).permute(
            0, 2, 1, 3).reshape(n_tiles, ts * ts)
    go_tiles = None
    leaves = None
    if grad_out is not None:
        go_tiles = {k: _to_tiles(v, tiles_x, tiles_y, ts) for k, v in
                    grad_out.items()}
        leaves = {k: proj[k].detach().requires_grad_(True)
                  for k in ("uv", "conic", "opacity", "colour")}
        grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    src = leaves if leaves is not None else proj
    for t0 in range(0, n_tiles, tile_block):
        tiles = torch.arange(t0, min(t0 + tile_block, n_tiles), device=dev)
        px = ((tiles % tiles_x) * ts)[:, None] + tpix[None, :] % ts
        py = ((tiles // tiles_x) * ts)[:, None] + tpix[None, :] // ts
        px, py = px.float()[..., None], py.float()[..., None]
        lim = None if dl_tiles is None else dl_tiles[tiles][..., None]

        def run(src):
            # the block's tiles walk their lists together, a chunk of
            # slots at a time (the chunk doubling up to 8x), and a tile
            # leaves the walk once its list ends or every pixel of it has
            # stopped
            n = tiles.shape[0]
            T = torch.ones((n, ts * ts), device=dev)
            rgb = torch.zeros((n, ts * ts, 3), device=dev)
            acc_a = torch.zeros_like(T)
            acc_d = torch.zeros_like(T)
            n_pairs = torch.zeros(T.shape, dtype=torch.int64, device=dev)
            n_entries = torch.zeros((n,), dtype=torch.int64, device=dev)
            act = torch.arange(n, device=dev)[lengths[tiles] > 0]
            s0, size = 0, chunk
            while act.numel():
                tl = tiles[act]
                slot = s0 + torch.arange(size, device=dev)
                ok = slot[None, :] < lengths[tl][:, None]
                at = torch.where(ok, start[tl][:, None] + slot[None, :],
                                 torch.zeros_like(slot)[None, :])
                g = ids[at]                                    # (A, C)
                uv, con = src["uv"][g], src["conic"][g]
                dx = px[act] - uv[:, None, :, 0]
                dy = py[act] - uv[:, None, :, 1]
                qf = (0.5 * (con[:, None, :, 0] * dx * dx
                             + con[:, None, :, 2] * dy * dy)
                      + con[:, None, :, 1] * dx * dy)
                alpha = torch.clamp_max(src["opacity"][g][:, None, :]
                                        * torch.exp(-qf), rc["alpha_clamp"])
                keep = (ok[:, None, :] & (alpha >= rc["alpha_min"])
                        & (qf >= 0))
                if lim is not None:
                    keep = keep & (proj["depth"][g][:, None, :] <= lim[act])
                alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
                one_minus = 1.0 - alpha
                before = torch.cat([torch.ones_like(one_minus[..., :1]),
                                    torch.cumprod(one_minus, -1)[..., :-1]],
                                   -1)
                t_act = T[act]
                tk = t_act[..., None] * before
                live = tk * one_minus >= rc["transmittance_min"]
                wgt = torch.where(live & keep, alpha * tk,
                                  torch.zeros_like(alpha))
                rgb = rgb.index_add(0, act, mm(wgt, src["colour"][g]))
                acc_a = acc_a.index_add(0, act, wgt.sum(-1))
                acc_d = acc_d.index_add(0, act, mm(
                    wgt, proj["depth"][g].detach()[..., None])[..., 0])
                if count:
                    used = live & keep
                    n_pairs = n_pairs.index_add(0, act, used.sum(-1))
                    n_entries = n_entries.index_add(0, act,
                                                    used.any(1).sum(-1))
                # after the first failed stop test a pixel adds nothing
                dead = (~live & keep).any(-1)
                t_new = torch.where(dead, torch.zeros_like(t_act),
                                    t_act * torch.prod(one_minus, -1))
                T = T.index_copy(0, act, t_new)
                s0 += size
                size = min(2 * size, 8 * chunk)
                more = ((t_new >= rc["transmittance_min"]).any(-1)
                        & (lengths[tl] > s0))
                act = act[more]
            return rgb, acc_a, acc_d, n_pairs, n_entries

        if grad_out is None:
            with torch.no_grad():
                rgb, acc_a, acc_d, n_pairs, n_entries = run(src)
        else:
            with torch.enable_grad():
                rgb, acc_a, acc_d, n_pairs, n_entries = run(src)
                loss = ((rgb * go_tiles["rgb"][tiles]).sum()
                        + (acc_a * go_tiles["alpha"][tiles]).sum())
                gs = torch.autograd.grad(loss, list(leaves.values()),
                                         allow_unused=True)
            for k, gk in zip(leaves, gs):
                if gk is not None:
                    grads[k] += gk
        out_rgb[tiles] = rgb.detach()
        out_a[tiles] = acc_a.detach()
        out_d[tiles] = acc_d.detach()
        pairs[tiles] = n_pairs
        entries[tiles] = n_entries
    res = {"rgb": _from_tiles(out_rgb, tiles_x, tiles_y, ts, width, height),
           "alpha": _from_tiles(out_a, tiles_x, tiles_y, ts, width, height),
           "depth": _from_tiles(out_d, tiles_x, tiles_y, ts, width, height)}
    if grad_out is not None:
        res["grads"] = grads
    if count:
        res["pairs"] = _from_tiles(pairs, tiles_x, tiles_y, ts, width,
                                   height)
        res["entries"] = entries
    return res


def _to_tiles(img: torch.Tensor, tiles_x: int, tiles_y: int, ts: int):
    """(H, W, ...) -> (T, ts*ts, ...), zero-padded to whole tiles."""
    h, w = img.shape[:2]
    rest = img.shape[2:]
    pad = img.new_zeros((tiles_y * ts, tiles_x * ts) + rest)
    pad[:h, :w] = img
    return pad.reshape((tiles_y, ts, tiles_x, ts) + rest).transpose(
        1, 2).reshape((tiles_y * tiles_x, ts * ts) + rest)


def _from_tiles(t: torch.Tensor, tiles_x: int, tiles_y: int, ts: int,
                width: int, height: int):
    rest = t.shape[2:]
    img = t.reshape((tiles_y, tiles_x, ts, ts) + rest).transpose(1, 2)
    return img.reshape((tiles_y * ts, tiles_x * ts) + rest)[:height, :width]
