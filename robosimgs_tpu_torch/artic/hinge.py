"""Hinge detection between two part meshes (contact region + PCA axis).

A port of robosimgs_tpu/artic/hinge.py, itself a redesign of the
upstream RoboSimGS HingeDetector
(`Articulation/urdf_generation/hinge_detector.py`): contact region =
vertices of each part within (min inter-part distance + 1 cm) of the
other part; hinge position = mean of the two contact centroids; axis =
principal eigenvector of the contact point covariance; confidence =
dominant-eigenvalue ratio with an X-axis fallback below 0.5. The
KD-tree nearest-neighbor queries become chunked matmul-style distance
minima on the device (`_min_dists`, the JAX package's formula and chunk
size); the rest is numpy, unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from robosimgs_tpu_torch.utils.meshio import Mesh


@dataclasses.dataclass
class HingeResult:
    position: np.ndarray        # (3,)
    axis: np.ndarray            # (3,) unit
    confidence: float
    contact_count_a: int
    contact_count_b: int


def _min_dists(a: torch.Tensor, b: torch.Tensor,
               chunk: int = 2048) -> torch.Tensor:
    """For each point in a: distance to nearest point in b.

    ||a-b||^2 = |a|^2 + |b|^2 - 2 a.b, the inner term one f32 matmul per
    chunk of 2048 rows of a, clamped at 0 before the min and the sqrt.
    The contact threshold sits near zero distance, where this form
    cancels: TF32 would move it by millimetres, so it must be off."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("_min_dists needs full f32 matmuls: "
                           "torch.backends.cuda.matmul.allow_tf32 is on")
    b2 = torch.sum(b * b, dim=1)
    out = []
    for s in range(0, a.shape[0], chunk):
        ac = a[s:s + chunk]
        a2 = torch.sum(ac * ac, dim=1, keepdim=True)
        d2 = a2 + b2[None, :] - 2.0 * ac @ b.T
        out.append(torch.clamp_min(d2, 0.0).amin(dim=1))
    return torch.sqrt(torch.cat(out))


class HingeDetector:
    def __init__(self, part_a: Mesh, part_b: Mesh,
                 contact_margin: float = 0.01, trim: int = 0,
                 device="cuda"):
        """contact_margin: added to the min inter-part distance (meters).

        trim: robust contact-PCA iterations — after each axis fit, drop
        contact points whose perpendicular distance to the fitted hinge
        LINE exceeds 2x the median, then refit. A mask-driven split
        that mislabels a band of faces along the junction produces fake
        contact pairs off the true hinge line; trimming recovers the
        line (no-op on clean geometric splits, where every contact
        point already lies on it). 0 = exact upstream semantics.

        device: where the pairwise distances run."""
        self.a = part_a
        self.b = part_b
        self.margin = contact_margin
        self.trim = trim
        self.device = torch.device(device)

    def distances(self):
        """(per-a-vertex distance to b, per-b-vertex distance to a), numpy."""
        va = torch.as_tensor(self.a.vertices, dtype=torch.float32,
                             device=self.device)
        vb = torch.as_tensor(self.b.vertices, dtype=torch.float32,
                             device=self.device)
        return (_min_dists(va, vb).cpu().numpy(),
                _min_dists(vb, va).cpu().numpy())

    def detect(self) -> HingeResult:
        da, db = self.distances()
        thresh = min(da.min(), db.min()) + self.margin
        ca = self.a.vertices[da <= thresh]
        cb = self.b.vertices[db <= thresh]
        if len(ca) == 0 or len(cb) == 0:
            # parts far apart: fall back to midpoint of nearest pair
            ia, ib = int(da.argmin()), int(db.argmin())
            pos = (self.a.vertices[ia] + self.b.vertices[ib]) / 2.0
            return HingeResult(position=pos.astype(np.float32),
                               axis=np.array([1, 0, 0], np.float32),
                               confidence=0.0, contact_count_a=0,
                               contact_count_b=0)

        contact = np.concatenate([ca, cb], 0)
        from_a = np.zeros(len(contact), bool)
        from_a[: len(ca)] = True

        def fit(points):
            centered = points - points.mean(0)
            cov = centered.T @ centered / max(len(points) - 1, 1)
            eigvals, eigvecs = np.linalg.eigh(cov)   # ascending
            return eigvals, eigvecs[:, -1], centered

        eigvals, axis, centered = fit(contact)
        for _ in range(self.trim):
            perp = np.linalg.norm(
                centered - np.outer(centered @ axis, axis), axis=1)
            ok = perp <= max(2.0 * np.median(perp), 1e-9)
            if ok.all() or ok.sum() < 8 or not (from_a[ok].any()
                                                and (~from_a)[ok].any()):
                break
            contact, from_a = contact[ok], from_a[ok]
            eigvals, axis, centered = fit(contact)
        ca_t, cb_t = contact[from_a], contact[~from_a]
        pos = (ca_t.mean(0) + cb_t.mean(0)) / 2.0
        total = eigvals.sum()
        confidence = float(eigvals[-1] / total) if total > 1e-12 else 0.0
        if confidence < 0.5:
            axis = np.array([1.0, 0.0, 0.0])
        axis = axis / np.linalg.norm(axis)
        return HingeResult(
            position=pos.astype(np.float32),
            axis=axis.astype(np.float32),
            confidence=confidence,
            contact_count_a=int(len(ca)),
            contact_count_b=int(len(cb)),
        )

    @staticmethod
    def translation_to_origin(hinge: HingeResult) -> np.ndarray:
        """Translation that moves the hinge position to the origin."""
        return (-hinge.position).astype(np.float32)
