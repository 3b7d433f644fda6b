"""span_gain kernel package (see ops.py)."""

from .ops import span_gains, span_gains_plain  # noqa: F401
