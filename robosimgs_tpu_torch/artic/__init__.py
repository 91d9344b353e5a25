"""The articulation toolchain (a port of robosimgs_tpu/artic/): part
segmentation and the learned mask model, hinge detection, URDF
synthesis, physics-parameter estimation, canonical views and the
pipeline that joins them."""

from robosimgs_tpu_torch.artic.hinge import HingeDetector, HingeResult
from robosimgs_tpu_torch.artic.urdf_builder import URDFBuilder
from robosimgs_tpu_torch.artic.pipeline import ArticulationPipeline

__all__ = ["HingeDetector", "HingeResult", "URDFBuilder", "ArticulationPipeline"]
