from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, RWKVConfig, TrainConfig  # noqa: F401
from repro_torch.configs.shapes import SHAPES, ShapeConfig, applicable, smoke_shape  # noqa: F401
