"""The training input pipeline (the reference's ``data/``)."""

from .pipeline import (HostStats, PlacementAwarePipeline,  # noqa: F401
                       SyntheticTokenSource)
