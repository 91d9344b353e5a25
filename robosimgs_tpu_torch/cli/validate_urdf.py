"""Headless URDF validation + optional articulation render.

A port of robosimgs_tpu/cli/validate_urdf.py, the replacement for the
upstream RoboSimGS PyBullet GUI smoke test
(`Articulation/utils/test_pybullet.py`) and its trimesh visualizer:
validates the kinematic structure, sweeps the joint range via FK, and
(with --render) writes a turntable strip of the articulation using the
mesh rasterizer, on the card unless `--device cpu` is given, without
Pillow. Falls back to a real PyBullet check when the package is
installed (--pybullet).

    python -m robosimgs_tpu_torch.cli.validate_urdf object.urdf --render strip.png
"""

from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser(description="Validate a generated URDF")
    p.add_argument("urdf", help="path to .urdf")
    p.add_argument("--render", default=None,
                   help="write an articulation strip PNG to this path")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--pybullet", action="store_true",
                   help="also load in PyBullet (if installed)")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default: cuda)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    import numpy as np

    from robosimgs_tpu_torch.scenegen.urdf_fk import URDFModel

    model = URDFModel.parse(args.urdf)
    problems = model.validate()
    print(f"robot {model.name!r}: {len(model.links)} links, "
          f"{len(model.joints)} joints ({model.dof} movable)")
    for j in model.movable:
        print(f"  joint {j.name}: {j.type} axis={j.axis.tolist()} "
              f"limits=[{j.lower:.3f}, {j.upper:.3f}]")
    if problems:
        for p in problems:
            print(f"PROBLEM: {p}")
        raise SystemExit(1)
    print("kinematic validation: OK")

    if args.render:
        import torch

        from robosimgs_tpu_torch.artic.render_views import (report_mesh_stats,
                                                            shade, view_camera)
        from robosimgs_tpu_torch.cli.render import write_png
        from robosimgs_tpu_torch.render.mesh_raster import (MeshRasterConfig,
                                                            rasterize_mesh)
        from robosimgs_tpu_torch.scenegen.rollout import ArticulatedObject
        from robosimgs_tpu_torch.utils.meshio import Mesh, concatenate

        dev = args.device
        obj = ArticulatedObject.from_urdf(args.urdf)
        frames = []
        for q in np.linspace(0, 1, args.steps):
            qs = np.asarray([j.lower + q * (j.upper - j.lower)
                             for j in model.movable])
            posed = obj.posed_meshes(qs, device=dev)
            merged = concatenate([
                Mesh(v.cpu().numpy(), f.cpu().numpy(),
                     c.cpu().numpy() if c is not None else None)
                for v, f, c in posed])
            cam = view_camera(merged, np.array([1.0, -1.0, 0.7]),
                              resolution=args.resolution, device=dev)
            fc = shade(merged, cam)
            with torch.no_grad():
                out = rasterize_mesh(torch.as_tensor(merged.vertices, device=dev),
                                     torch.as_tensor(merged.faces, device=dev),
                                     cam, face_colors=torch.as_tensor(
                                         fc, device=dev))
            report_mesh_stats("validate_urdf", out["stats"], MeshRasterConfig())
            img = np.where(out["mask"].cpu().numpy()[..., None],
                           out["rgb"].cpu().numpy(), 1.0)
            frames.append(img)
        strip = np.concatenate(frames, axis=1)
        write_png(args.render, (np.clip(strip, 0, 1) * 255).astype(np.uint8))
        print(f"articulation strip written to {args.render}")

    if args.pybullet:
        try:
            import pybullet as pb
        except ImportError:
            print("pybullet not installed; skipped")
            return
        cid = pb.connect(pb.DIRECT)
        robot = pb.loadURDF(args.urdf)
        print(f"pybullet load: OK ({pb.getNumJoints(robot)} joints)")
        pb.disconnect(cid)


if __name__ == "__main__":
    main()
