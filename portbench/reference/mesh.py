"""Plain rollout frames: URDF forward kinematics, a z-buffer triangle
raster and the depth merge with the splat background.

  * the URDF is read from its text: each joint's origin (xyz, roll-pitch-
    yaw as Rz Ry Rx), revolute joints turning about their axis, a link's
    world pose = parent's pose x joint origin x joint motion, the root at
    the object's base pose;
  * a triangle covers the pixel centres (integer coordinates, the splat
    camera's projection) whose barycentric weights against its screen
    triangle are all >= 0; its depth there is the perspective-correct
    1 / (sum w_i / z_i); each pixel keeps the nearest triangle (the
    lower face index on a tie, the earlier link on a tie between links)
    and its perspective-correct vertex colour;
  * the splats composite with the mesh depth as each pixel's depth
    limit, and what transmittance is left falls through to the mesh
    colour, or the background where no triangle covers the pixel.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET

import numpy as np
import torch

from portbench.reference import splats


def _rpy(r: float, p: float, y: float) -> np.ndarray:
    cr, sr, cp, sp = math.cos(r), math.sin(r), math.cos(p), math.sin(p)
    cy, sy = math.cos(y), math.sin(y)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rz @ ry @ rx


def _origin(el) -> np.ndarray:
    m = np.eye(4)
    if el is not None:
        m[:3, :3] = _rpy(*[float(x) for x in el.get("rpy", "0 0 0").split()])
        m[:3, 3] = [float(x) for x in el.get("xyz", "0 0 0").split()]
    return m


def _rotation(axis, angle: float) -> np.ndarray:
    x, y, z = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    c, s = math.cos(angle), math.sin(angle)
    k = np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]])
    return np.eye(3) + s * k + (1 - c) * (k @ k)


def link_poses(urdf: str, q: np.ndarray, base: np.ndarray) -> dict:
    """{link name: (4, 4) world pose (float64)} at joint positions q (one
    a movable joint, in document order)."""
    root = ET.fromstring(urdf)
    joints = root.findall("joint")
    movable = [j for j in joints if j.get("type") in ("revolute",
                                                      "continuous",
                                                      "prismatic")]
    qmap = {j.get("name"): float(v) for j, v in zip(movable, q)}
    children = {j.find("child").get("link") for j in joints}
    links = [el.get("name") for el in root.findall("link")]
    (root_link,) = [n for n in links if n not in children]
    poses = {root_link: np.asarray(base, np.float64)}
    while len(poses) < len(links):
        for j in joints:
            parent, child = j.find("parent").get("link"), j.find("child").get(
                "link")
            if parent in poses and child not in poses:
                motion = np.eye(4)
                ax = j.find("axis")
                axis = [float(x) for x in (ax.get("xyz") if ax is not None
                                           else "1 0 0").split()]
                angle = qmap.get(j.get("name"), 0.0)
                if j.get("type") in ("revolute", "continuous"):
                    motion[:3, :3] = _rotation(axis, angle)
                elif j.get("type") == "prismatic":
                    motion[:3, 3] = np.asarray(axis) / np.linalg.norm(
                        axis) * angle
                poses[child] = poses[parent] @ _origin(j.find("origin")) @ motion
    return poses


def posed_links(obj: dict, q: np.ndarray, base: np.ndarray) -> list:
    """[(vertices (V, 3) world f32, faces, colours)] of each link with a
    visual, in the URDF's link order."""
    poses = link_poses(obj["urdf"], q, base)
    root = ET.fromstring(obj["urdf"])
    out = []
    for el in root.findall("link"):
        vis = el.find("visual")
        name = el.get("name")
        if vis is None or name not in obj["links"]:
            continue
        mesh = obj["links"][name]
        m = poses[name] @ _origin(vis.find("origin"))
        scale = np.ones(3)
        geo = vis.find("geometry/mesh")
        if geo is not None and geo.get("scale"):
            scale = np.asarray([float(x) for x in geo.get("scale").split()])
        v = (mesh["vertices"].astype(np.float64) * scale) @ m[:3, :3].T \
            + m[:3, 3]
        out.append((v.astype(np.float32), mesh["faces"], mesh["colors"]))
    return out


def raster(vertices, faces, colours, cam: dict, near: float,
           device) -> dict:
    """Z-buffer one triangle mesh: {"rgb" (H, W, 3), "depth" (H, W), +inf
    where uncovered, "face" (H, W) int64, -1 where uncovered,
    "candidates": the (triangle, pixel) pairs tested}."""
    W, H = cam["width"], cam["height"]
    v = torch.as_tensor(vertices, device=device)
    f = torch.as_tensor(faces, device=device).long()
    col = torch.as_tensor(colours, device=device)
    p = splats.mm(v, cam["R"].T) + cam["t"]
    z = p[:, 2]
    uv = torch.stack([cam["fx"] * p[:, 0] / z + cam["cx"] - 0.5,
                      cam["fy"] * p[:, 1] / z + cam["cy"] - 0.5], -1)
    tri = uv[f]                                              # (F, 3, 2)
    tz = z[f]
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    area = ((b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1])
            - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0]))
    ok = (tz > near).all(1) & (area.abs() > 1e-12)
    x0 = torch.clamp(torch.ceil(tri[..., 0].amin(1)), 0, W - 1).long()
    x1 = torch.clamp(torch.floor(tri[..., 0].amax(1)), -1, W - 1).long()
    y0 = torch.clamp(torch.ceil(tri[..., 1].amin(1)), 0, H - 1).long()
    y1 = torch.clamp(torch.floor(tri[..., 1].amax(1)), -1, H - 1).long()
    bw = torch.where(ok, (x1 - x0 + 1).clamp_min(0), torch.zeros_like(x0))
    n_px = bw * (y1 - y0 + 1).clamp_min(0)
    tid = torch.repeat_interleave(torch.arange(f.shape[0], device=device),
                                  n_px)
    e = torch.arange(tid.shape[0], device=device) - (
        torch.cumsum(n_px, 0) - n_px)[tid]
    row = torch.div(e, bw[tid], rounding_mode="floor")
    px = (x0[tid] + e - row * bw[tid]).float()
    py = (y0[tid] + row).float()
    ta, tb, tc = a[tid], b[tid], c[tid]
    inv = 1.0 / area[tid]
    wa = ((tc[:, 0] - tb[:, 0]) * (py - tb[:, 1])
          - (tc[:, 1] - tb[:, 1]) * (px - tb[:, 0])) * inv
    wb = ((ta[:, 0] - tc[:, 0]) * (py - tc[:, 1])
          - (ta[:, 1] - tc[:, 1]) * (px - tc[:, 0])) * inv
    wc = 1.0 - wa - wb
    w = torch.stack([wa, wb, wc], -1)
    invz = (w / tz[tid]).sum(-1)
    inside = (w >= 0).all(-1) & (invz > 0)
    depth = torch.where(inside, 1.0 / torch.clamp_min(invz, 1e-12),
                        torch.full_like(invz, math.inf))
    pix = (py.long() * W + px.long())
    best = torch.full((H * W,), math.inf, device=device)
    best = best.scatter_reduce(0, pix, depth, "amin")
    win = inside & (depth == best[pix])
    big = torch.iinfo(torch.int64).max
    face = torch.full((H * W,), big, dtype=torch.int64, device=device)
    face = face.scatter_reduce(0, pix[win], tid[win], "amin")
    hit = face < big
    sel = win & (face[pix] == tid)
    rgb = torch.zeros((H * W, 3), device=device)
    wz = w[sel] / tz[tid[sel]]
    c_px = (wz[..., None] * col[f[tid[sel]]]).sum(1) / invz[sel][:, None]
    rgb[pix[sel]] = c_px
    return {"rgb": rgb.reshape(H, W, 3), "candidates": int(tid.shape[0]),
            "depth": torch.where(hit, best, torch.full_like(best, math.inf)
                                 ).reshape(H, W),
            "face": torch.where(hit, face, torch.full_like(face, -1)
                                ).reshape(H, W)}


def frame(params: dict, links: list, cam: dict, rc: dict, near: float,
          background: torch.Tensor, count: bool = False) -> dict:
    """One camera's rollout frame: {"rgb" (H, W, 3), "mesh" (H, W) bool,
    "ambiguous" (H, W) bool: where two links' nearest surfaces lie within
    a relative 1e-5 of each other, so rounding decides which one shows}
    (and with count the needed work: the compositing's pairs and entries,
    the raster's candidates)."""
    dev = params["means"].device
    layers = [raster(v, f, c, cam, near, dev) for v, f, c in links]
    ambiguous = torch.zeros((cam["height"], cam["width"]), dtype=torch.bool,
                            device=dev)
    for i, a in enumerate(layers):
        for b in layers[i + 1:]:
            both = torch.isfinite(a["depth"]) & torch.isfinite(b["depth"])
            ambiguous |= both & ((a["depth"] - b["depth"]).abs()
                                 <= 1e-5 * torch.minimum(a["depth"],
                                                         b["depth"]))
    if layers:
        out = layers[0]
        for nxt in layers[1:]:
            closer = nxt["depth"] < out["depth"]
            out = {"rgb": torch.where(closer[..., None], nxt["rgb"],
                                      out["rgb"]),
                   "depth": torch.minimum(out["depth"], nxt["depth"]),
                   "face": torch.where(closer, nxt["face"], out["face"])}
        limit = out["depth"]
        mesh = out["face"] >= 0
        behind = torch.where(mesh[..., None], out["rgb"], background)
    else:
        limit, mesh = None, None
        behind = background
    with torch.no_grad():
        proj = splats.project(params, cam, rc)
        sp = splats.composite(proj, cam["width"], cam["height"], rc,
                              depth_limit=limit, count=count)
    res = {"rgb": sp["rgb"] + (1 - sp["alpha"])[..., None] * behind,
           "mesh": mesh, "ambiguous": ambiguous}
    if count:
        res["pairs"], res["entries"] = sp["pairs"], sp["entries"]
        res["candidates"] = sum(lay["candidates"] for lay in layers)
    return res
