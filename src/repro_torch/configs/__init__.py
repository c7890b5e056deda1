from .registry import ARCHS, get_config, get_smoke_config, SHAPES, get_shape  # noqa: F401
