"""robosimgs_tpu_torch — the PyTorch/CUDA port of robosimgs_tpu.

A second package beside the JAX one, for one NVIDIA H100: plain tensor
code is torch, and each Pallas TPU kernel of the JAX package becomes a
kernel written by hand for Hopper (csrc/). It imports nothing from JAX or
from robosimgs_tpu; the JAX package stays the reference its tests hold
it against.

Ported so far: the 3DGS render path (core/, render/, train/io_ply.py,
cli/render.py), the 3DGS training step (train/, cli/train.py), the
rollout render path (render/mesh_raster.py, render/compose.py,
render/autotune.py, scenegen/, utils/meshio.py, cli/render_rollout.py)
the diffusion-policy stage (policy/: the model, its trainer, action
chunking and closed-loop evaluation in the rollout renderer;
utils/imresize.py; cli/train_policy.py) and the articulation toolchain
(artic/: segmentation, the mask model, hinge, URDF, physics; utils/
morphology.py, bake.py, pointcloud.py; cli/articulate.py and its
companions), compositing through csrc/composite_fwd.cu and its backward
csrc/composite_bwd.cu.
"""

import torch

# Numerics pinned once, for every module: full f32 matmuls and
# convolutions on the card. The JAX package pins f32 wherever it matters
# (render/project.py's unrolled f32 geometry, Precision.HIGHEST in the
# compositors and the SSIM blur), and Camera.w2c is a matmul; TF32 keeps
# ~3 digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.2.0"

from robosimgs_tpu_torch.core.types import Gaussians  # noqa: E402
from robosimgs_tpu_torch.core.camera import Camera  # noqa: E402

__all__ = ["Gaussians", "Camera", "__version__"]
