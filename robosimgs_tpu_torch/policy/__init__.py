from robosimgs_tpu_torch.policy.diffusion import (DiffusionPolicy,
                                                  DiffusionPolicyConfig)
from robosimgs_tpu_torch.policy.inference import ActionChunker
from robosimgs_tpu_torch.policy.trainer import PolicyTrainer, PolicyTrainConfig

__all__ = ["DiffusionPolicy", "DiffusionPolicyConfig", "PolicyTrainer",
           "PolicyTrainConfig", "ActionChunker"]
