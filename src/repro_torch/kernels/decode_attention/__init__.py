"""decode_attention kernel package (see ops.py)."""

from .ops import decode_attention, decode_attention_plain  # noqa: F401
