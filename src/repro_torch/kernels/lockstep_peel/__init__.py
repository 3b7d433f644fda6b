"""lockstep_peel kernel package (see ops.py)."""

from .ops import lockstep_peel, lockstep_peel_plain  # noqa: F401
