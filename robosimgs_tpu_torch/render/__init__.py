from robosimgs_tpu_torch.render.config import RenderConfig
from robosimgs_tpu_torch.render.rasterize import rasterize

__all__ = ["RenderConfig", "rasterize"]
