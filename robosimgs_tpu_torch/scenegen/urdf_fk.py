"""URDF parsing + forward kinematics (pose playback for rollouts).

A numpy copy of robosimgs_tpu/scenegen/urdf_fk.py (the port imports
nothing from the JAX package): links with a visual mesh, material color
and inertial; revolute/continuous/prismatic/fixed joints with
origin/axis/limit/dynamics. FK drives rollout rendering and doubles as
the headless URDF validity check. URDFs, link meshes and joint
configurations are files and numpy arrays on both sides, so nothing
needs converting between the packages.
"""

from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np


def rpy_to_matrix(rpy) -> np.ndarray:
    """URDF fixed-axis roll-pitch-yaw -> 3x3 rotation (R = Rz @ Ry @ Rx)."""
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return (Rz @ Ry @ Rx).astype(np.float32)


def _origin_matrix(el: Optional[ET.Element]) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    if el is not None:
        xyz = [float(x) for x in el.get("xyz", "0 0 0").split()]
        rpy = [float(x) for x in el.get("rpy", "0 0 0").split()]
        T[:3, :3] = rpy_to_matrix(rpy)
        T[:3, 3] = xyz
    return T


def _axis_angle_matrix(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = axis / np.linalg.norm(axis)
    x, y, z = axis
    c, s = np.cos(angle), np.sin(angle)
    C = 1 - c
    return np.array([
        [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, c + z * z * C]], np.float32)


@dataclasses.dataclass
class URDFJoint:
    name: str
    type: str                  # revolute | continuous | prismatic | fixed
    parent: str
    child: str
    origin: np.ndarray         # (4, 4)
    axis: np.ndarray           # (3,)
    lower: float = 0.0
    upper: float = 0.0
    effort: float = 0.0
    velocity: float = 0.0
    friction: float = 0.0
    damping: float = 0.0


@dataclasses.dataclass
class URDFLink:
    name: str
    visual_mesh: Optional[str] = None     # mesh filename (relative)
    visual_origin: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32))
    visual_scale: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32))
    color: Optional[np.ndarray] = None
    mass: float = 0.0
    inertia: Optional[np.ndarray] = None  # (6,) ixx ixy ixz iyy iyz izz


class URDFModel:
    def __init__(self, name: str, links: Dict[str, URDFLink],
                 joints: List[URDFJoint], base_dir: str = "."):
        self.name = name
        self.links = links
        self.joints = joints
        self.base_dir = base_dir
        children = {j.child for j in joints}
        roots = [ln for ln in links if ln not in children]
        if len(roots) != 1:
            raise ValueError(f"URDF must have exactly one root link, got {roots}")
        self.root = roots[0]
        self.movable = [j for j in joints
                        if j.type in ("revolute", "continuous", "prismatic")]

    @property
    def dof(self) -> int:
        return len(self.movable)

    @staticmethod
    def parse(path_or_xml: str, base_dir: Optional[str] = None) -> "URDFModel":
        if os.path.exists(path_or_xml):
            tree = ET.parse(path_or_xml)
            root = tree.getroot()
            base_dir = base_dir or os.path.dirname(os.path.abspath(path_or_xml))
        else:
            root = ET.fromstring(path_or_xml)
            base_dir = base_dir or "."
        links: Dict[str, URDFLink] = {}
        for lel in root.findall("link"):
            link = URDFLink(name=lel.get("name"))
            vis = lel.find("visual")
            if vis is not None:
                link.visual_origin = _origin_matrix(vis.find("origin"))
                mesh = vis.find("geometry/mesh")
                if mesh is not None:
                    link.visual_mesh = mesh.get("filename")
                    link.visual_scale = np.asarray(
                        [float(x) for x in mesh.get("scale", "1 1 1").split()],
                        np.float32)
                col = vis.find("material/color")
                if col is not None:
                    link.color = np.asarray(
                        [float(x) for x in col.get("rgba").split()][:3], np.float32)
            inertial = lel.find("inertial")
            if inertial is not None:
                mval = inertial.find("mass")
                link.mass = float(mval.get("value")) if mval is not None else 0.0
                iel = inertial.find("inertia")
                if iel is not None:
                    link.inertia = np.asarray(
                        [float(iel.get(k, "0")) for k in
                         ("ixx", "ixy", "ixz", "iyy", "iyz", "izz")], np.float32)
            links[link.name] = link
        joints: List[URDFJoint] = []
        for jel in root.findall("joint"):
            lim = jel.find("limit")
            dyn = jel.find("dynamics")
            ax = jel.find("axis")
            joints.append(URDFJoint(
                name=jel.get("name"),
                type=jel.get("type"),
                parent=jel.find("parent").get("link"),
                child=jel.find("child").get("link"),
                origin=_origin_matrix(jel.find("origin")),
                axis=np.asarray([float(x) for x in
                                 (ax.get("xyz") if ax is not None else "1 0 0").split()],
                                np.float32),
                lower=float(lim.get("lower", "0")) if lim is not None else 0.0,
                upper=float(lim.get("upper", "0")) if lim is not None else 0.0,
                effort=float(lim.get("effort", "0")) if lim is not None else 0.0,
                velocity=float(lim.get("velocity", "0")) if lim is not None else 0.0,
                friction=float(dyn.get("friction", "0")) if dyn is not None else 0.0,
                damping=float(dyn.get("damping", "0")) if dyn is not None else 0.0,
            ))
        return URDFModel(root.get("name", "robot"), links, joints, base_dir)

    def joint_motion(self, joint: URDFJoint, q: float) -> np.ndarray:
        M = np.eye(4, dtype=np.float32)
        if joint.type in ("revolute", "continuous"):
            M[:3, :3] = _axis_angle_matrix(joint.axis, q)
        elif joint.type == "prismatic":
            M[:3, 3] = joint.axis / np.linalg.norm(joint.axis) * q
        return M

    def fk(self, q: Optional[Dict[str, float] | np.ndarray] = None,
           base: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """Link world transforms for joint positions q (dict by joint name
        or array over self.movable order)."""
        if q is None:
            qmap = {}
        elif isinstance(q, dict):
            qmap = q
        else:
            qmap = {j.name: float(v) for j, v in zip(self.movable, np.asarray(q))}
        out = {self.root: np.eye(4, dtype=np.float32) if base is None
               else np.asarray(base, np.float32)}
        pending = list(self.joints)
        while pending:
            advanced = False
            for j in list(pending):
                if j.parent in out:
                    motion = self.joint_motion(j, qmap.get(j.name, 0.0))
                    out[j.child] = out[j.parent] @ j.origin @ motion
                    pending.remove(j)
                    advanced = True
            if not advanced:
                raise ValueError(f"disconnected joints: {[j.name for j in pending]}")
        return out

    def clamp(self, q: np.ndarray) -> np.ndarray:
        lo = np.asarray([j.lower for j in self.movable])
        hi = np.asarray([j.upper for j in self.movable])
        cont = np.asarray([j.type == "continuous" for j in self.movable])
        return np.where(cont, q, np.clip(q, lo, hi))

    def load_link_meshes(self, loader=None) -> Dict[str, "object"]:
        """Load each link's visual mesh (relative to base_dir)."""
        from robosimgs_tpu_torch.utils.meshio import load_mesh
        loader = loader or load_mesh
        out = {}
        for name, link in self.links.items():
            if link.visual_mesh:
                path = link.visual_mesh
                if not os.path.isabs(path):
                    path = os.path.join(self.base_dir, path)
                out[name] = loader(path)
        return out

    def validate(self) -> List[str]:
        """Headless URDF sanity check (in place of a PyBullet GUI smoke
        test): returns a list of problems, empty if OK."""
        problems = []
        for j in self.joints:
            if j.parent not in self.links:
                problems.append(f"joint {j.name}: unknown parent {j.parent}")
            if j.child not in self.links:
                problems.append(f"joint {j.name}: unknown child {j.child}")
            if j.type in ("revolute", "prismatic") and j.lower > j.upper:
                problems.append(f"joint {j.name}: lower {j.lower} > upper {j.upper}")
            if np.linalg.norm(j.axis) < 1e-9 and j.type != "fixed":
                problems.append(f"joint {j.name}: zero axis")
        try:
            self.fk()
        except ValueError as e:
            problems.append(str(e))
        # articulate through the joint range
        for j in self.movable:
            for q in np.linspace(j.lower, j.upper, 5):
                T = self.fk({j.name: float(q)})
                for name, M in T.items():
                    if not np.isfinite(M).all():
                        problems.append(f"non-finite FK at {j.name}={q:.3f} ({name})")
        return problems
