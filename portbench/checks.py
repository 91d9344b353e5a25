"""The numbers that decide `correct`, each against the limit of its cell
(portbench/limits/<cell>.json).

Training: each checked step's loss, the first gradient's norm and the
parameters' change after the checked steps, leaf by leaf (a leaf is a
parameter group): the gap between the program's norm and the
reference's, over the reference's norm of that leaf or of the median
leaf, whichever is larger, and the worst leaf. A leaf whose reference
gradient is under a thousandth of the median leaf's moves by round-off
alone and is left out of the change.

Images: the root-mean-square difference of each compared image from the
reference's, and the share of its pixels whose colour differs from the
reference's by more than 1/255 in some channel, each of the worst image.
Where two surfaces of a mesh lie within rounding of each other (the lid
resting on the box), which one a pixel shows is decided by rounding, so a
few such pixels differ by a whole colour on any sound run.
"""

from __future__ import annotations

import math
import statistics

import torch


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tensors.items()}


def leaf_gap(program: dict, reference: dict, skip=()) -> float:
    """max over leaves of |program norm - reference norm| / max(reference
    norm, median reference norm)."""
    med = statistics.median(reference.values())
    return max(abs(program[k] - reference[k]) / max(reference[k], med, 1e-30)
               for k in reference if k not in skip)


def quiet_leaves(grad_norms: dict) -> set:
    med = statistics.median(grad_norms.values())
    return {k for k, v in grad_norms.items() if v < 1e-3 * med}


def loss_gap(program: list, reference: list) -> float:
    return max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(program, reference))


def rms(a, b) -> float:
    a = torch.as_tensor(a, dtype=torch.float64)
    b = torch.as_tensor(b, dtype=torch.float64, device=a.device)
    d = a - b
    if not bool(torch.isfinite(d).all()):
        return math.inf
    return float(torch.sqrt(torch.mean(d * d)))


def bad_pixels(a, b, tol: float = 1.0 / 255.0) -> float:
    """Share of the pixels of (..., H, W, 3) images whose largest channel
    difference exceeds tol (or is not finite)."""
    a = torch.as_tensor(a, dtype=torch.float64)
    b = torch.as_tensor(b, dtype=torch.float64, device=a.device)
    d = (a - b).abs().amax(-1)
    return float(((d > tol) | ~torch.isfinite(d)).double().mean())


def judged(limits: dict, values: dict) -> list:
    """[(name, value, limit, value <= limit)] in the limits' order; a
    number that is not finite fails."""
    out = []
    for name, limit in limits.items():
        v = float(values[name])
        out.append((name, v, limit, math.isfinite(v) and v <= limit))
    return out
