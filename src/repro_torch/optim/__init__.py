"""Optimizers and gradient compression of the training path (the
reference's ``optim/``)."""

from .compression import (apply_error_feedback, int8_compress,  # noqa: F401
                          int8_decompress)
from .optimizers import (  # noqa: F401
    Optimizer,
    adafactor,
    adamw,
    clip_by_global_norm,
    cosine_schedule,
    make_optimizer,
)
