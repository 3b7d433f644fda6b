"""The fault-tolerant training runtime (the reference's ``runtime/``;
``elastic_remesh`` waits for the mesh, ROADMAP Queue 1 item 9.6)."""

from .fault_tolerance import (FaultTolerantRunner, HostHealth,  # noqa: F401
                              StepFailure)
from .straggler import StragglerDetector  # noqa: F401
