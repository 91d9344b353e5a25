"""Articulation toolchain configuration + output directory layout.

A copy of robosimgs_tpu/artic/config.py (the port imports nothing from
the JAX package). It keeps the upstream RoboSimGS Config contract
(`Articulation/utils/config.py`): an input mesh path derives
`<stem>_output/{segmentation,parts,urdf}` directories, so outputs are
drop-in comparable with the upstream `openbox_output/` tree.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional


@dataclasses.dataclass
class ArticConfig:
    input_file: str
    output_dir: Optional[str] = None
    render_resolution: int = 800
    render_fov_deg: float = 50.0
    camera_distance_factor: float = 2.0   # x bbox diagonal
    mask_dilate_px: int = 10
    contact_margin: float = 0.01
    n_surface_samples: int = 100_000

    def __post_init__(self):
        stem = os.path.splitext(os.path.basename(self.input_file))[0]
        if self.output_dir is None:
            self.output_dir = os.path.join(
                os.path.dirname(os.path.abspath(self.input_file)),
                f"{stem}_output")
        self.segmentation_dir = os.path.join(self.output_dir, "segmentation")
        self.parts_dir = os.path.join(self.output_dir, "parts")
        self.urdf_dir = os.path.join(self.output_dir, "urdf")
        for d in (self.segmentation_dir, self.parts_dir, self.urdf_dir):
            os.makedirs(d, exist_ok=True)
