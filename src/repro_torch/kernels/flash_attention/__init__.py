"""flash_attention kernel package (see ops.py)."""

from .ops import flash_attention, flash_attention_plain  # noqa: F401
