"""cover_rounds kernel package (see ops.py)."""

from .ops import cover_rounds, cover_rounds_plain  # noqa: F401
