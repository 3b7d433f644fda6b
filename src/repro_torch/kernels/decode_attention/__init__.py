"""decode_attention kernel package (see ops.py)."""

from .ops import (decode_attention, decode_attention_latent,  # noqa: F401
                  decode_attention_latent_plain, decode_attention_plain)
