from repro_torch.configs.base import ARCH_IDS, INPUT_SHAPES, ModelConfig, ShapeConfig, get_config, shape_supported

__all__ = ["ARCH_IDS", "INPUT_SHAPES", "ModelConfig", "ShapeConfig", "get_config", "shape_supported"]
