from .optimizers import (  # noqa: F401
    OptState,
    adafactor_init,
    adafactor_update,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
    make_optimizer,
)
