"""Multi-device training and rendering on torch.distributed: meshes
(mesh.py), the collectives (comm.py), the sharded train steps and pool
management (distributed.py) and the ring-streamed Gaussian set
(ring.py). A port of robosimgs_tpu/parallel/."""

from robosimgs_tpu_torch.parallel.distributed import (make_dp_train_step,
                                                      stack_cameras)
from robosimgs_tpu_torch.parallel.mesh import make_mesh

__all__ = ["make_mesh", "make_dp_train_step", "stack_cameras"]
