"""Nerfstudio interop the training path needs: gzip'd .npy depth maps.

The one function of robosimgs_tpu/utils/nerfstudio.py that
`train/data.py::Frame.load_depth` reads; the rest arrives with the
slices that use it.
"""

from __future__ import annotations

import gzip
import io

import numpy as np


def load_depth_npy_gz(path: str) -> np.ndarray:
    """Load a gzip-compressed .npy depth map (Nerfstudio export format)."""
    with gzip.open(path, "rb") as fh:
        return np.load(io.BytesIO(fh.read()))
