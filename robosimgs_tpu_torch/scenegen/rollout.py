"""Multi-camera photoreal rollout rendering (simulated data generation).

A port of robosimgs_tpu/scenegen/rollout.py: a trained background
Gaussian scene composited with articulated object meshes posed by a
joint trajectory (URDF FK), rendered from C cameras per timestep,
depth-merged by render/compose.py. On a CUDA device every (timestep,
camera) composites its splats through the compositing kernel once.

The background crosses over from the JAX package with
core/convert.gaussians_from_numpy; URDFs, meshes and trajectories are
files and numpy arrays on both sides. The JAX package's jit caches have
no counterpart in eager torch. Camera sharding (camera_mesh) renders
each data rank's share of the cameras against the replicated scene and
gathers the frames once, at the end (parallel/).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from robosimgs_tpu_torch.core.camera import Camera
from robosimgs_tpu_torch.core.types import Gaussians
from robosimgs_tpu_torch.render.compose import render_composite
from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.mesh_raster import MeshRasterConfig
from robosimgs_tpu_torch.scenegen.urdf_fk import URDFModel
from robosimgs_tpu_torch.utils.meshio import Mesh
from robosimgs_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class ArticulatedObject:
    """A URDF-articulated object placed in the world."""

    model: URDFModel
    link_meshes: Dict[str, Mesh]
    base_pose: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32))
    # pose-independent per-link appearance, baked once (texture
    # sampling at scan-scale meshes is O(V) — not per timestep)
    _link_colors: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict, repr=False)

    @staticmethod
    def from_urdf(path: str, base_pose: Optional[np.ndarray] = None) -> "ArticulatedObject":
        model = URDFModel.parse(path)
        return ArticulatedObject(
            model=model, link_meshes=model.load_link_meshes(),
            base_pose=base_pose if base_pose is not None
            else np.eye(4, dtype=np.float32))

    def posed_meshes(self, q, base_pose=None, device="cuda") -> List[tuple]:
        """World-space (vertices, faces, colors) tensors on `device`, per
        link at joint config q. base_pose overrides the object's resting
        pose (moving objects in manipulation rollouts). The posing is
        numpy, as in the JAX package, so both pose the same floats."""
        T = self.model.fk(q, base=self.base_pose if base_pose is None
                          else base_pose)
        out = []
        for name, mesh in self.link_meshes.items():
            link = self.model.links[name]
            M = T[name] @ link.visual_origin
            scaled = mesh.vertices * link.visual_scale[None, :]
            v = scaled @ M[:3, :3].T + M[:3, 3]
            colors = self._link_colors.get(name)
            if colors is None:
                colors = mesh.baked_vertex_colors()
                if colors is None:
                    base = (link.color if link.color is not None
                            else np.full(3, 0.7))
                    colors = np.tile(base.astype(np.float32),
                                     (v.shape[0], 1))
                self._link_colors[name] = colors
            out.append(tuple(torch.as_tensor(np.ascontiguousarray(x),
                                             device=device)
                             for x in (v, mesh.faces, colors)))
        return out


def _quantize_u8(rgb: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(rgb * 255.0), 0, 255).to(torch.uint8)


def rollout_meshes(objects: Sequence[ArticulatedObject],
                   trajectory: np.ndarray,
                   base_poses: Optional[np.ndarray] = None,
                   device="cuda") -> Iterator[List[tuple]]:
    """Per timestep, the posed (vertices, faces, colors) of every link of
    every object on `device`: the meshes render_rollout draws (trajectory
    columns are the objects' movable joints in order; a base pose with a
    NaN entry is the object's resting pose)."""
    dof_split = np.cumsum([o.model.dof for o in objects])[:-1] if objects else []
    for t in range(trajectory.shape[0]):
        with span("rollout.pose"):
            qs = (np.split(np.asarray(trajectory[t]), dof_split) if objects
                  else [])
            meshes = []
            for i, (obj, q) in enumerate(zip(objects, qs)):
                base = base_poses[t, i] if base_poses is not None else None
                if base is not None and np.isnan(base).any():
                    base = None   # never in the trajectory: resting pose
                meshes.extend(obj.posed_meshes(q, base_pose=base,
                                               device=device))
        yield meshes


def render_rollout(
    background: Gaussians,
    objects: Sequence[ArticulatedObject],
    trajectory: np.ndarray,               # (T, total_dof) joint positions
    cameras: Sequence[Camera],
    cfg: RenderConfig = RenderConfig(),
    mesh_cfg: MeshRasterConfig = MeshRasterConfig(),
    background_color: Optional[torch.Tensor] = None,
    impl: str = "auto",
    base_poses: Optional[np.ndarray] = None,   # (T, n_objects, 4, 4)
    batch_cameras: bool = False,
    camera_mesh=None,
    as_uint8: bool = False,
) -> np.ndarray:
    """Render (T, C, H, W, 3) rollout frames on the device of the
    background's tensors (a CUDA device unless the caller loaded it
    elsewhere).

    trajectory columns are the concatenation of each object's movable
    joints in order; base_poses optionally moves each object rigidly per
    timestep (NaN entries: the object's resting pose). as_uint8
    quantizes on the device; the frames cross to the host once, at the
    end. batch_cameras is accepted and renders the same frames (in eager
    torch every camera is its own call either way).

    camera_mesh: a ("data", "tile") DeviceMesh (parallel/mesh.py) that
    every rank of it passes, with the same arguments: data rank d renders
    cameras [d C/n_data, (d+1) C/n_data) against the replicated scene
    (nothing is shared while rendering; a 'tile' axis replicates), and
    the frames are all-gathered over 'data' once, so every rank returns
    the whole (T, C, H, W, 3). len(cameras) must divide by the 'data'
    size, and the cameras share one resolution.
    """
    dev = background.device
    if camera_mesh is not None:
        from robosimgs_tpu_torch.parallel.mesh import axis_size
        n_data = axis_size(camera_mesh, "data")
        if len(cameras) % n_data or len({(c.width, c.height)
                                         for c in cameras}) != 1:
            raise ValueError(f"{len(cameras)} cameras of one resolution "
                             f"are needed to shard over {n_data} ranks")
        local = len(cameras) // n_data
        d = camera_mesh.get_local_rank("data")
        cameras = cameras[d * local:(d + 1) * local]
    bg_color = (torch.zeros((3,), device=dev) if background_color is None
                else torch.as_tensor(background_color, dtype=torch.float32,
                                     device=dev))
    cameras = [c.to(dev) for c in cameras]
    frames = []
    with torch.no_grad():
        posed = rollout_meshes(objects, trajectory, base_poses, dev)
        for _ in range(trajectory.shape[0]):
            with span("rollout.frame"):
                meshes = next(posed)
                frame = torch.stack([
                    render_composite(background, cam, meshes, cfg, mesh_cfg,
                                     background=bg_color, impl=impl)["rgb"]
                    for cam in cameras])
                frames.append(_quantize_u8(frame) if as_uint8 else frame)
        frames = torch.stack(frames)
        if camera_mesh is not None:
            from robosimgs_tpu_torch.parallel import comm
            frames = comm.all_gather(frames, camera_mesh.get_group("data"),
                                     dim=1)
        with span("rollout.to_host"):
            return frames.cpu().numpy()


def open_close_trajectory(model: URDFModel, steps: int) -> np.ndarray:
    """A simple open-then-close trajectory through each joint's range."""
    ts = np.linspace(0.0, 1.0, steps)
    phase = 0.5 - 0.5 * np.cos(2 * np.pi * ts)   # 0 -> 1 -> 0
    lo = np.asarray([j.lower for j in model.movable])
    hi = np.asarray([j.upper for j in model.movable])
    return (lo[None, :] + phase[:, None] * (hi - lo)[None, :]).astype(np.float32)
