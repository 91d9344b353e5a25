"""URDF document builder (XML synthesis via ElementTree).

A copy of robosimgs_tpu/artic/urdf_builder.py (the port imports nothing
from the JAX package). It produces the artifact contract of the upstream
RoboSimGS string-template builder
(`Articulation/urdf_generation/urdf_builder.py`): links with
visual+collision mesh geometry, per-link material color, inertial with
default mass/diagonal inertia, revolute joints with
origin/axis/limit/dynamics, fixed joints. Built on ElementTree rather
than string pasting so output is always well-formed.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Optional, Sequence
from xml.dom import minidom

_DEFAULT_INERTIA = (0.01, 0.0, 0.0, 0.01, 0.0, 0.01)  # ixx ixy ixz iyy iyz izz


class URDFBuilder:
    def __init__(self, robot_name: str = "articulated_object"):
        self.root = ET.Element("robot", name=robot_name)

    def add_link(
        self,
        name: str,
        mesh_filename: Optional[str] = None,
        scale: Sequence[float] = (1.0, 1.0, 1.0),
        color: Sequence[float] = (0.7, 0.7, 0.7, 1.0),
        mass: float = 0.5,
        inertia: Sequence[float] = _DEFAULT_INERTIA,
        origin_xyz: Sequence[float] = (0.0, 0.0, 0.0),
    ) -> "URDFBuilder":
        link = ET.SubElement(self.root, "link", name=name)
        if mesh_filename is not None:
            for section in ("visual", "collision"):
                sec = ET.SubElement(link, section)
                geom = ET.SubElement(sec, "geometry")
                ET.SubElement(geom, "mesh", filename=mesh_filename,
                              scale=" ".join(f"{s:g}" for s in scale))
                if section == "visual":
                    mat = ET.SubElement(sec, "material", name=f"{name}_material")
                    ET.SubElement(mat, "color",
                                  rgba=" ".join(f"{c:g}" for c in color))
        inertial = ET.SubElement(link, "inertial")
        ET.SubElement(inertial, "mass", value=f"{mass:g}")
        ET.SubElement(inertial, "origin",
                      xyz=" ".join(f"{x:g}" for x in origin_xyz), rpy="0 0 0")
        ixx, ixy, ixz, iyy, iyz, izz = inertia
        ET.SubElement(inertial, "inertia", ixx=f"{ixx:g}", ixy=f"{ixy:g}",
                      ixz=f"{ixz:g}", iyy=f"{iyy:g}", iyz=f"{iyz:g}",
                      izz=f"{izz:g}")
        return self

    def add_revolute_joint(
        self,
        name: str,
        parent: str,
        child: str,
        axis: Sequence[float],
        origin_xyz: Sequence[float] = (0.0, 0.0, 0.0),
        origin_rpy: Sequence[float] = (0.0, 0.0, 0.0),
        lower: float = -0.785,
        upper: float = 0.785,
        effort: float = 5.0,
        velocity: float = 2.0,
        friction: float = 0.5,
        damping: float = 0.2,
    ) -> "URDFBuilder":
        joint = ET.SubElement(self.root, "joint", name=name, type="revolute")
        ET.SubElement(joint, "parent", link=parent)
        ET.SubElement(joint, "child", link=child)
        ET.SubElement(joint, "origin",
                      xyz=" ".join(f"{x:.6f}" for x in origin_xyz),
                      rpy=" ".join(f"{x:.6f}" for x in origin_rpy))
        ET.SubElement(joint, "axis",
                      xyz=" ".join(f"{x:.6f}" for x in axis))
        ET.SubElement(joint, "limit", lower=f"{lower:.6f}", upper=f"{upper:.6f}",
                      effort=f"{effort:.2f}", velocity=f"{velocity:.2f}")
        ET.SubElement(joint, "dynamics", friction=f"{friction:.2f}",
                      damping=f"{damping:.2f}")
        return self

    def add_fixed_joint(
        self, name: str, parent: str, child: str,
        origin_xyz: Sequence[float] = (0.0, 0.0, 0.0),
        origin_rpy: Sequence[float] = (0.0, 0.0, 0.0),
    ) -> "URDFBuilder":
        joint = ET.SubElement(self.root, "joint", name=name, type="fixed")
        ET.SubElement(joint, "parent", link=parent)
        ET.SubElement(joint, "child", link=child)
        ET.SubElement(joint, "origin",
                      xyz=" ".join(f"{x:.6f}" for x in origin_xyz),
                      rpy=" ".join(f"{x:.6f}" for x in origin_rpy))
        return self

    def to_string(self) -> str:
        rough = ET.tostring(self.root, encoding="unicode")
        pretty = minidom.parseString(rough).toprettyxml(indent="  ")
        # strip the minidom XML declaration line and blank lines
        lines = [ln for ln in pretty.splitlines()[1:] if ln.strip()]
        return '<?xml version="1.0"?>\n' + "\n".join(lines) + "\n"

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_string())
