"""Render a trained 3DGS scene (.ply) from chosen viewpoints.

Scenes trained by the JAX package or by any standard 3DGS stack
(Nerfstudio/gsplat) render identically. Cameras come from a
transforms.json (`--transforms`), an orbit or an explicit look-at.
Renders on the card unless `--device cpu` is given.

    python -m robosimgs_tpu_torch.cli.render scene.ply --output views --orbit 8
"""

from __future__ import annotations

import argparse
import os
import struct
import sys
import zlib

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="Render a 3DGS .ply scene")
    p.add_argument("scene", help=".ply in standard 3DGS layout")
    p.add_argument("--output", required=True, help="output dir or .png file")
    p.add_argument("--transforms", default=None,
                   help="render the cameras of a transforms.json")
    p.add_argument("--orbit", type=int, default=0,
                   help="render N orbit views around the scene center")
    p.add_argument("--eye", type=float, nargs=3, default=None)
    p.add_argument("--target", type=float, nargs=3, default=[0, 0, 0])
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--background", type=float, nargs=3, default=[1, 1, 1])
    p.add_argument("--sh-degree", type=int, default=None)
    p.add_argument("--impl", default="auto")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default: cuda)")
    return p


def encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> the bytes of an 8-bit RGB PNG (zlib, no filter)."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray) -> None:
    """(H, W, 3) uint8 -> 8-bit RGB PNG file (zlib, no filter)."""
    with open(path, "wb") as f:
        f.write(encode_png(rgb))


def orbit_cameras(g, n: int, fov: float, width: int, height: int,
                  device="cuda"):
    """n look-at cameras on a circle around the median of the live
    splats, at twice their 90th-percentile radius, raised 0.4 radius."""
    from robosimgs_tpu_torch.core.camera import Camera

    alive = g.alive.cpu().numpy()
    pts = g.means.cpu().numpy()[alive]
    center = np.median(pts, 0)
    radius = 2.0 * np.percentile(np.linalg.norm(pts - center, axis=1), 90)
    cams = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        eye = center + radius * np.array([np.cos(ang), np.sin(ang), 0.4])
        cams.append(Camera.look_at(eye, center, [0, 0, 1], fov, width, height,
                                   device=device))
    return cams


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from robosimgs_tpu_torch.core.camera import Camera
    from robosimgs_tpu_torch.render.config import RenderConfig
    from robosimgs_tpu_torch.render.rasterize import rasterize
    from robosimgs_tpu_torch.train.io_ply import load_ply

    g = load_ply(args.scene, device=args.device)
    print(f"loaded {args.scene}: {int(g.num_alive)} gaussians, "
          f"SH degree {g.sh_degree}, device {g.device}")

    cams = []
    names = []
    if args.transforms:
        from robosimgs_tpu_torch.train.data import parse_transforms_json

        for i, f in enumerate(parse_transforms_json(args.transforms,
                                                    device=args.device)):
            cams.append(f.camera)
            names.append(f"view_{i:04d}")
    elif args.orbit:
        cams = orbit_cameras(g, args.orbit, args.fov, args.width, args.height,
                             device=args.device)
        names = [f"orbit_{i:04d}" for i in range(args.orbit)]
    elif args.eye:
        cams.append(Camera.look_at(args.eye, args.target, [0, 0, 1],
                                   args.fov, args.width, args.height,
                                   device=args.device))
        names.append("view")
    else:
        raise SystemExit("one of --transforms / --orbit / --eye required")

    bg = torch.tensor(args.background, dtype=torch.float32, device=args.device)
    single = len(cams) == 1 and not os.path.isdir(args.output) \
        and args.output.lower().endswith(".png")
    if not single:
        os.makedirs(args.output, exist_ok=True)
    for cam, name in zip(cams, names):
        with torch.no_grad():
            out = rasterize(g, cam, sh_degree=args.sh_degree, background=bg,
                            impl=args.impl, return_stats=True)
        img = (np.clip(out["rgb"].cpu().numpy(), 0, 1) * 255).astype(np.uint8)
        path = args.output if single else os.path.join(args.output,
                                                       f"{name}.png")
        write_png(path, img)
        print(f"wrote {path}")
        st = out.get("stats")   # the tiled path bins; the reference does not
        if st is not None and (int(st.truncated_gaussians)
                               or int(st.overflowed_tiles)):
            print(f"render: {name} at tile capacity {RenderConfig().tile_capacity}"
                  f" drops splats: {int(st.truncated_gaussians)} truncated "
                  f"gaussians, {int(st.overflowed_tiles)} overflowed tiles (up "
                  f"to {int(st.max_tile_count)} splats a tile); "
                  f"render/autotune.py::recommend_capacities sizes lossless "
                  f"capacities for these cameras", file=sys.stderr)


if __name__ == "__main__":
    main()
