"""flash_attention kernel package (see ops.py)."""

from .ops import (flash_attention, flash_attention_bwd,  # noqa: F401
                  flash_attention_bwd_plain, flash_attention_latent,
                  flash_attention_latent_bwd,
                  flash_attention_latent_bwd_plain,
                  flash_attention_latent_lse,
                  flash_attention_latent_lse_plain,
                  flash_attention_latent_plain, flash_attention_lse,
                  flash_attention_lse_plain, flash_attention_plain)
