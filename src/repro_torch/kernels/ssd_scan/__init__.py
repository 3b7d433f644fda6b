"""ssd_scan kernel package (see ops.py)."""

from .ops import ssd_scan, ssd_scan_plain  # noqa: F401
