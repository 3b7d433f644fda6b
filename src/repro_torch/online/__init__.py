"""repro_torch.online — online serving over the placement engine.

The batch pipeline (``repro_torch.core``) fits a layout and replays a
static trace; this package serves queries AGAINST that layout while it
changes:

  router    — streaming replica-selection router: microbatched
              batched_cover_csr calls on the router's ``device``, optional
              load-aware tie-break (``flags.FLAGS["router_balance"]``)
  drift     — sliding-window workload sketch + windowed-avg-span drift
              trigger invoking PlacementService.refit (hot-swap between
              microbatches)
  failover  — partition down/up masking, coverage audit, span-aware repair
              of lost replicas into surviving free space
  migration — live plan migration: old-vs-new layout diff, bandwidth-paced
              replica transfer schedule (``flags.FLAGS
              ["migration_bandwidth"]``), union-layout serving until every
              copy lands, copies-before-drops per item

`Simulator.run_online` (``repro_torch.core.simulator``) wires them into an
event-capable trace replay.  A copy of the JAX package's ``online``
package: the router and the drift detector's spans run the span engine on
an explicit device; failover and migration are host bookkeeping over the
shared numpy member matrix.
"""

__all__ = [
    "ReplicaRouter", "RoutedBatch", "queries_to_csr",
    "DriftDetector", "WorkloadSketch",
    "FailoverManager",
    "MigrationExecutor", "MigrationPlan", "PlanDiff", "TransferEvent",
    "diff_plans", "diff_plans_reference", "plan_migration",
]

from .router import ReplicaRouter, RoutedBatch, queries_to_csr  # noqa: F401
from .drift import DriftDetector, WorkloadSketch  # noqa: F401
from .failover import FailoverManager  # noqa: F401
from .migration import (  # noqa: F401
    MigrationExecutor,
    MigrationPlan,
    PlanDiff,
    TransferEvent,
    diff_plans,
    diff_plans_reference,
    plan_migration,
)
