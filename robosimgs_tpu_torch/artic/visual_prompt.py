"""Visual prompting ops for mask ranking (the FGVP role).

A port of robosimgs_tpu/artic/visual_prompt.py. The upstream RoboSimGS
segmenter optionally sharpens CLIP mask-ranking with FGVP's blur-mask
prompt: the candidate region stays sharp while the rest of the image is
heavily Gaussian-blurred (std 100 at 800px). The blur is the separable
f32 band-matrix blur of train/losses.py, on the image's device.
"""

from __future__ import annotations

import numpy as np
import torch

from robosimgs_tpu_torch.train.losses import _blur


def gaussian_blur(image: torch.Tensor, std: float) -> torch.Tensor:
    """Separable Gaussian blur of (H, W, C); window = 4 std (odd), at
    most 2 min(H, W) - 1 taps."""
    size = int(4 * std) | 1
    size = min(size, 2 * min(image.shape[:2]) - 1)
    return _blur(image, size, float(std))


def blur_mask_prompt(image: torch.Tensor, mask: torch.Tensor,
                     std: float = 100.0,
                     reference_res: int = 800) -> torch.Tensor:
    """Blur-mask visual prompt: sharp inside the mask, blurred outside.

    std is specified at `reference_res` resolution and scaled to the
    actual image size (the upstream segmenter used std=100 at 800px
    renders).
    """
    h = image.shape[0]
    eff_std = max(1.0, std * h / reference_res)
    blurred = gaussian_blur(image, eff_std)
    return torch.where(mask[..., None], image, blurred)


def crop_prompt(image: np.ndarray, mask: np.ndarray, pad: int = 8,
                background: float = 1.0) -> np.ndarray:
    """Crop-to-mask visual prompt (numpy; the upstream grid-crop
    candidate images for MLLM selection)."""
    ys, xs = np.where(mask)
    if len(ys) == 0:
        return np.asarray(image)
    y0, y1 = max(ys.min() - pad, 0), min(ys.max() + pad + 1, mask.shape[0])
    x0, x1 = max(xs.min() - pad, 0), min(xs.max() + pad + 1, mask.shape[1])
    crop = np.where(mask[y0:y1, x0:x1, None], image[y0:y1, x0:x1], background)
    return crop
