"""Headless visualization of a split/articulation result.

A port of robosimgs_tpu/cli/visualize_parts.py, the counterpart of the
upstream RoboSimGS trimesh/Open3D scene viewer
(`Articulation/utils/visualize.py`): renders the split parts in distinct
colors with the hinge axis drawn as a colored line of spheres, from
three viewpoints, into one PNG strip — no GUI. Renders on the card
unless `--device cpu` is given; writes the PNG without Pillow.

    python -m robosimgs_tpu_torch.cli.visualize_parts openbox_output
"""

from __future__ import annotations

import argparse
import json
import os


def build_parser():
    p = argparse.ArgumentParser(description="Render split parts + hinge axis")
    p.add_argument("output_dir", help="an <input>_output directory "
                                      "(with urdf/metadata.json)")
    p.add_argument("--out", default=None, help="output PNG (default "
                                               "<output_dir>/visualization.png)")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default: cuda)")
    return p


PART_COLORS = [(0.85, 0.45, 0.35), (0.35, 0.65, 0.85),
               (0.45, 0.8, 0.45), (0.85, 0.8, 0.35)]


def main(argv=None):
    args = build_parser().parse_args(argv)
    import numpy as np
    import torch

    from robosimgs_tpu_torch.artic.render_views import (report_mesh_stats,
                                                        view_camera)
    from robosimgs_tpu_torch.cli.render import write_png
    from robosimgs_tpu_torch.render.mesh_raster import (MeshRasterConfig,
                                                        rasterize_mesh)
    from robosimgs_tpu_torch.utils.meshio import Mesh, concatenate, load_mesh

    urdf_dir = os.path.join(args.output_dir, "urdf")
    meta = json.load(open(os.path.join(urdf_dir, "metadata.json")))
    meshes = []
    for i, key in enumerate(("base_mesh", "movable_mesh")):
        m = load_mesh(os.path.join(urdf_dir, meta["files"][key]))
        c = np.tile(np.asarray(PART_COLORS[i % len(PART_COLORS)], np.float32),
                    (m.vertices.shape[0], 1))
        meshes.append(Mesh(m.vertices, m.faces, c))

    # hinge axis as a dotted line of small diamonds through the origin
    axis = np.asarray(meta["hinge"]["axis"], np.float32)
    merged0 = concatenate(meshes)
    diag = float(np.linalg.norm(merged0.bounds[1] - merged0.bounds[0]))
    dots = []
    for t in np.linspace(-0.6 * diag, 0.6 * diag, 41):
        c = axis * t
        s = 0.006 * diag
        v = np.array([c + [s, 0, 0], c - [s, 0, 0], c + [0, s, 0],
                      c - [0, s, 0], c + [0, 0, s], c - [0, 0, s]], np.float32)
        f = np.array([[0, 2, 4], [0, 4, 3], [0, 3, 5], [0, 5, 2],
                      [1, 4, 2], [1, 3, 4], [1, 5, 3], [1, 2, 5]], np.int32)
        col = np.tile(np.asarray([1.0, 0.9, 0.1], np.float32), (6, 1))
        dots.append(Mesh(v, f, col))
    scene = concatenate(meshes + dots)

    views = []
    scene_colors = scene.baked_vertex_colors()   # view-independent
    dev = args.device
    verts = torch.as_tensor(scene.vertices, device=dev)
    faces = torch.as_tensor(scene.faces, device=dev)
    cols = (None if scene_colors is None
            else torch.as_tensor(scene_colors, device=dev))
    for direction in ([1.0, -1.0, 0.7], [-1.0, -1.0, 0.7], [0.0, 0.0, 1.0]):
        cam = view_camera(scene, np.asarray(direction), args.resolution,
                          device=dev)
        with torch.no_grad():
            out = rasterize_mesh(verts, faces, cam, vertex_colors=cols)
        report_mesh_stats("visualize_parts", out["stats"], MeshRasterConfig())
        img = np.where(out["mask"].cpu().numpy()[..., None],
                       out["rgb"].cpu().numpy(), 1.0)
        views.append(img)
    strip = np.concatenate(views, axis=1)
    out_path = args.out or os.path.join(args.output_dir, "visualization.png")
    write_png(out_path, (np.clip(strip, 0, 1) * 255).astype(np.uint8))
    print(f"hinge axis {axis.tolist()} "
          f"(confidence {meta['hinge']['axis_confidence']:.3f})")
    print(f"visualization written to {out_path}")


if __name__ == "__main__":
    main()
