from robosimgs_tpu_torch.scenegen.urdf_fk import URDFModel
from robosimgs_tpu_torch.scenegen.rollout import ArticulatedObject, render_rollout

__all__ = ["URDFModel", "ArticulatedObject", "render_rollout"]
