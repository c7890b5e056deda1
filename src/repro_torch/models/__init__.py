"""PyTorch LM model stack: the same exported names as ``repro.models``."""
from .config import ModelConfig, MoEConfig  # noqa: F401
from .model import (  # noqa: F401
    DecoderLM,
    init_params,
    forward,
    init_kv_cache,
    decode_step,
    loss_fn,
)
