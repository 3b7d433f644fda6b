"""Live plan migration: bandwidth-paced replica transfers, union serving.

A drift refit or a `fit_sharded` hot-swap produces a NEW `PlacementPlan`;
teleporting the live layout onto it between two router microbatches moves
data for free, which no real cluster gets.  This module treats a placement
change as the incremental transfer problem it is (rucio's conveyor daemons
are the operational exemplar: queued transfers, bandwidth-aware pacing,
per-destination throttling):

* `diff_plans(old, new)` — the replica delta between two layouts: `copies`
  (destination gains a replica) and `drops` (destination loses one).  The
  vectorized diff equals a brute-force pairwise sweep
  (`diff_plans_reference`).
* `MigrationPlan` — a serializable, deterministic transfer schedule: the
  diff in a fixed order (ascending (item, destination)), a preferred source
  per copy (the lowest-id old holder), and the pacing configuration
  (``migration_bandwidth`` weight-units per served query,
  ``migration_concurrency`` in-flight transfers per destination,
  ``migration_headroom`` capacity slack).  ``apply`` replays the whole diff
  instantly — ``apply(diff_plans(a, b), a) == b`` is the round-trip
  property the suite pins.
* `MigrationExecutor` — streams the plan against the LIVE `Placement` the
  router serves from, one tick per served query.  Mid-migration the live
  member matrix is exactly the **union layout**: an item stays routable at
  its old locations until its copy lands, new locations appear as copies
  complete, and an old replica is dropped only once EVERY new copy of its
  item has landed and is live (copies-before-drops, per item).  Space for
  an incoming copy is reserved when its transfer starts, and a transfer
  never starts unless the destination's reserved load stays within
  ``capacity * (1 + headroom)`` — so the headroom bound holds by
  construction at every tick, and coverage is never lost.

Failure interaction (`on_partition_down` / `on_partition_up`): when a
transfer endpoint dies, its in-flight transfers abort (bytes wasted, the
copy re-queues at the head of the schedule), copies already landed there
are masked with the row and counted un-landed again, and the drops waiting
on them are deferred — old replicas are retained until the destination
recovers, so the union layout keeps serving through the outage and the
migration completes to the exact target once the partition returns.  A
migration may also START during an outage: the constructor's ``down``
argument seeds the already-dead partitions so their copies and drops are
deferred from tick zero exactly like a mid-flight failure (the plan should
be diffed against the post-restore layout — see
`FailoverManager.restored_member` — so the dead partition's stale replicas
get scheduled drops instead of silently surviving the row restore).

A copy of the JAX package's migration module: host bookkeeping over the
shared numpy member matrix, with no device.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np

from .. import flags as _flags
from .. import obs as _obs
from ..core.setcover import Placement

__all__ = [
    "PlanDiff",
    "diff_plans",
    "diff_plans_reference",
    "MigrationPlan",
    "plan_migration",
    "TransferEvent",
    "MigrationExecutor",
]


def _as_member(obj) -> np.ndarray:
    member = getattr(obj, "member", obj)
    member = np.asarray(member)
    if member.dtype != bool or member.ndim != 2:
        raise TypeError("expected a (N, V) bool member matrix "
                        "(or a Placement/PlacementPlan holding one)")
    return member


@dataclasses.dataclass
class PlanDiff:
    """Replica delta old -> new, in ascending (item, partition) order.

    copy_dest[i] gains a replica of copy_item[i]; drop_part[j] loses its
    replica of drop_item[j]."""

    copy_dest: np.ndarray  # (C,) int64
    copy_item: np.ndarray  # (C,) int64
    drop_part: np.ndarray  # (D,) int64
    drop_item: np.ndarray  # (D,) int64

    @property
    def num_copies(self) -> int:
        return len(self.copy_dest)

    @property
    def num_drops(self) -> int:
        return len(self.drop_part)


def diff_plans(old, new) -> PlanDiff:
    """Vectorized replica delta between two layouts of the same shape."""
    old_m, new_m = _as_member(old), _as_member(new)
    if old_m.shape != new_m.shape:
        raise ValueError(
            f"layout shapes differ: {old_m.shape} vs {new_m.shape}"
        )
    cp, ci = np.nonzero((new_m & ~old_m).T)  # transpose: (item, dest) order
    dp, di = np.nonzero((old_m & ~new_m).T)
    return PlanDiff(
        copy_dest=ci.astype(np.int64), copy_item=cp.astype(np.int64),
        drop_part=di.astype(np.int64), drop_item=dp.astype(np.int64),
    )


def diff_plans_reference(old, new) -> PlanDiff:
    """Brute-force pairwise sweep over every (partition, item) cell — the
    retained oracle `diff_plans` is asserted equal to."""
    old_m, new_m = _as_member(old), _as_member(new)
    if old_m.shape != new_m.shape:
        raise ValueError(
            f"layout shapes differ: {old_m.shape} vs {new_m.shape}"
        )
    copies, drops = [], []
    n, v = old_m.shape
    for item in range(v):
        for p in range(n):
            if new_m[p, item] and not old_m[p, item]:
                copies.append((p, item))
            elif old_m[p, item] and not new_m[p, item]:
                drops.append((p, item))
    return PlanDiff(
        copy_dest=np.array([p for p, _ in copies], dtype=np.int64),
        copy_item=np.array([i for _, i in copies], dtype=np.int64),
        drop_part=np.array([p for p, _ in drops], dtype=np.int64),
        drop_item=np.array([i for _, i in drops], dtype=np.int64),
    )


@dataclasses.dataclass
class MigrationPlan:
    """Deterministic transfer schedule from one layout to another.

    The copy/drop arrays are a `PlanDiff` in ascending (item, destination)
    order; ``copy_src`` is the preferred source per copy (lowest-id holder
    in the OLD layout; the executor re-picks a live source at transfer
    start, so a dead preferred source never stalls a copy).  ``target`` is
    the destination `PlacementPlan` when the plan came out of
    `PlacementService.refit(as_migration=True)`; it is a convenience
    pointer, never serialized."""

    num_partitions: int
    num_items: int
    copy_dest: np.ndarray
    copy_item: np.ndarray
    copy_src: np.ndarray
    drop_part: np.ndarray
    drop_item: np.ndarray
    bandwidth: float
    concurrency: int
    headroom: float
    target: "object | None" = None  # PlacementPlan; not serialized

    # ------------------------------------------------------------ accessors
    @property
    def num_copies(self) -> int:
        return len(self.copy_dest)

    @property
    def num_drops(self) -> int:
        return len(self.drop_part)

    @property
    def is_noop(self) -> bool:
        return self.num_copies == 0 and self.num_drops == 0

    def bytes_to_move(self, node_weights) -> float:
        """Total transfer volume (weight units) of the copy schedule."""
        w = np.asarray(node_weights, dtype=np.float64)
        return float(w[self.copy_item].sum())

    def inflight_bound(self, node_weights) -> float:
        """Worst-case concurrent in-flight volume (weight units), by
        construction: at most ``concurrency`` active transfers per distinct
        destination, each no larger than the biggest scheduled copy."""
        if not self.num_copies:
            return 0.0
        w = np.asarray(node_weights, dtype=np.float64)
        n_dests = len(np.unique(self.copy_dest))
        return float(self.concurrency * n_dests * w[self.copy_item].max())

    # ------------------------------------------------------------- instant
    def apply(self, member: np.ndarray) -> np.ndarray:
        """Replay the whole diff instantly (the legacy atomic hot-swap),
        in place: copies first, then drops."""
        member[self.copy_dest, self.copy_item] = True
        member[self.drop_part, self.drop_item] = False
        return member

    def schedule(self, placement: Placement) -> "list[TransferEvent]":
        """The failure-free event schedule from ``placement`` (the starting
        layout; copied — running a schedule never mutates the input):
        executes the plan on a scratch executor and returns its events."""
        scratch = Placement(
            placement.member.copy(), placement.capacity,
            placement.node_weights,
        )
        ex = MigrationExecutor(self, scratch)
        guard = 0
        while not ex.done:
            ex.advance(1)
            guard += 1
            if guard > 10_000_000:  # pragma: no cover - defensive
                raise RuntimeError("migration schedule failed to converge")
        return ex.events

    # ------------------------------------------------------- serialization
    def to_json(self) -> str:
        return json.dumps(dict(
            num_partitions=int(self.num_partitions),
            num_items=int(self.num_items),
            copies=[
                [int(d), int(v), int(s)] for d, v, s in
                zip(self.copy_dest, self.copy_item, self.copy_src)
            ],
            drops=[
                [int(p), int(v)] for p, v in
                zip(self.drop_part, self.drop_item)
            ],
            bandwidth=float(self.bandwidth),
            concurrency=int(self.concurrency),
            headroom=float(self.headroom),
        ))

    @staticmethod
    def from_json(s: str) -> "MigrationPlan":
        d = json.loads(s)
        copies = np.asarray(d["copies"], dtype=np.int64).reshape(-1, 3)
        drops = np.asarray(d["drops"], dtype=np.int64).reshape(-1, 2)
        return MigrationPlan(
            num_partitions=int(d["num_partitions"]),
            num_items=int(d["num_items"]),
            copy_dest=copies[:, 0], copy_item=copies[:, 1],
            copy_src=copies[:, 2],
            drop_part=drops[:, 0], drop_item=drops[:, 1],
            bandwidth=float(d["bandwidth"]),
            concurrency=int(d["concurrency"]),
            headroom=float(d["headroom"]),
        )


def plan_migration(
    old, new,
    node_weights: np.ndarray | None = None,
    bandwidth: float | None = None,
    concurrency: int | None = None,
    headroom: float | None = None,
    target=None,
) -> MigrationPlan:
    """Diff ``old`` -> ``new`` (each a `Placement`, `PlacementPlan` or bool
    member matrix) into a `MigrationPlan`.  Pacing parameters default to
    ``flags.FLAGS["migration_bandwidth" / "migration_concurrency" /
    "migration_headroom"]``.  With ``node_weights`` the target layout is
    checked for coverage (every weight > 0 item must be placed somewhere —
    migrating to a layout that loses an item would break serving)."""
    old_m, new_m = _as_member(old), _as_member(new)
    diff = diff_plans(old_m, new_m)
    if node_weights is not None:
        w = np.asarray(node_weights, dtype=np.float64)
        missing = np.flatnonzero(~new_m.any(axis=0) & (w > 0))
        if len(missing):
            raise ValueError(
                f"target layout leaves {len(missing)} items uncovered, "
                f"e.g. {missing[:5]}"
            )
    # preferred source: lowest-id OLD holder (argmax of a bool column); an
    # item never held in the old layout has no source (-1) and its copy can
    # only start once some live replica exists (e.g. placed by repair)
    held = old_m.any(axis=0)
    src = np.where(
        held[diff.copy_item],
        old_m[:, diff.copy_item].argmax(axis=0) if diff.num_copies
        else np.zeros(0, dtype=np.int64),
        -1,
    ).astype(np.int64)
    bw = (float(_flags.FLAGS.get("migration_bandwidth", 0.0))
          if bandwidth is None else float(bandwidth))
    conc = (int(_flags.FLAGS.get("migration_concurrency", 4))
            if concurrency is None else int(concurrency))
    head = (float(_flags.FLAGS.get("migration_headroom", 0.10))
            if headroom is None else float(headroom))
    if bw < 0:
        raise ValueError(f"migration bandwidth must be >= 0, got {bw}")
    if conc < 1:
        raise ValueError(f"migration concurrency must be >= 1, got {conc}")
    if head < 0:
        raise ValueError(f"migration headroom must be >= 0, got {head}")
    return MigrationPlan(
        num_partitions=old_m.shape[0], num_items=old_m.shape[1],
        copy_dest=diff.copy_dest, copy_item=diff.copy_item, copy_src=src,
        drop_part=diff.drop_part, drop_item=diff.drop_item,
        bandwidth=bw, concurrency=conc, headroom=head, target=target,
    )


@dataclasses.dataclass
class TransferEvent:
    """One state change of the live layout: a copy landing or a drop.

    ``tick`` is the serving-time position (queries served since the
    migration began); ``src`` is the partition the copy streamed from
    (-1 for drops and for copies satisfied without a transfer, e.g. a
    repair already placed the replica)."""

    tick: int
    kind: str  # "copy" | "drop"
    partition: int
    item: int
    src: int = -1


class _Transfer:
    """An in-flight copy: schedule index, remaining volume, live source."""

    __slots__ = ("idx", "dest", "item", "src", "size", "remaining",
                 "t0", "tick0")

    def __init__(self, idx: int, dest: int, item: int, src: int,
                 size: float, t0: float = 0.0, tick0: int = 0):
        self.idx = idx
        self.dest = dest
        self.item = item
        self.src = src
        self.size = size
        self.remaining = size
        self.t0 = t0        # perf_counter at start (trace mode only)
        self.tick0 = tick0  # executor tick at start


class MigrationExecutor:
    """Streams a `MigrationPlan` against the live `Placement`, one tick per
    served query.

    Per tick, in order: (1) deferred drops whose partitions came back are
    executed, (2) eligible pending copies are started — schedule order,
    skipping (not blocking on) copies whose destination is down, over its
    concurrency cap, or out of headroom, and reserving the copy's weight at
    the destination on start, (3) the tick's ``bandwidth`` budget is spent
    over the active transfers in start order (sequential fill, FIFO-biased),
    landed copies flip their member bit, and (4) items whose LAST copy just
    landed release their drops.  The member matrix is the router's, mutated
    in place — serving reads the union layout with no notification needed.

    ``refresh_loads`` must be called after any external mutation of the
    member matrix (failover repair); down/up notifications refresh
    implicitly.  ``down`` seeds partitions that are ALREADY down at
    migration start (their member rows masked by the caller): copies
    to/from them are deferred exactly like a mid-flight failure and
    `on_partition_up` re-arms them once the row is restored.  A migration
    that can make no progress with nothing down raises RuntimeError, naming
    the cause: a pending copy whose item no live partition holds (the plan
    only validates coverage of the TARGET layout), or headroom too tight
    (every pending copy is blocked on space only drops can free, and every
    drop waits on a blocked copy).
    """

    def __init__(self, plan: MigrationPlan, placement: Placement,
                 down=()):
        if placement.member.shape != (plan.num_partitions, plan.num_items):
            raise ValueError(
                f"placement shape {placement.member.shape} does not match "
                f"plan ({plan.num_partitions}, {plan.num_items})"
            )
        if plan.bandwidth <= 0 and plan.num_copies:
            raise ValueError(
                "executing a migration needs bandwidth > 0; "
                "bandwidth 0 means the instant swap (MigrationPlan.apply)"
            )
        self.plan = plan
        self.pl = placement
        self.now = 0
        self.events: list[TransferEvent] = []
        self._cap = placement.capacity_vec * (1.0 + plan.headroom)
        self._w = placement.node_weights
        self._pending: list[int] = list(range(plan.num_copies))
        self._active: list[_Transfer] = []
        self._landed = np.zeros(plan.num_copies, dtype=bool)
        # copies of each item still missing from the live layout (drops of
        # the item wait for this to reach zero with every copy host live)
        self._unlanded = np.bincount(
            plan.copy_item, minlength=plan.num_items
        ).astype(np.int64)
        self._drops_of: dict[int, list[int]] = {}
        for j, v in enumerate(plan.drop_item):
            self._drops_of.setdefault(int(v), []).append(j)
        self._drop_done = np.zeros(plan.num_drops, dtype=bool)
        # drops ready to execute but deferred (down partition) or ready at
        # start (items whose copies all pre-exist / pure-drop items)
        self._ready_drops: list[int] = [
            j for v, js in sorted(self._drops_of.items())
            if self._unlanded[v] == 0 for j in js
        ]
        self._down: set[int] = {int(p) for p in down}
        self._base_load = placement.partition_weights()
        self._reserved = np.zeros(plan.num_partitions, dtype=np.float64)
        self._inflight = 0.0
        self._dirty = True  # attempt starts on the next tick
        self.stats = dict(
            copies_done=0, drops_done=0,
            migration_transferred=0.0, migration_wasted=0.0,
            max_inflight=0.0, stall_ticks=0, aborted_transfers=0,
        )

    # ------------------------------------------------------------ accessors
    @property
    def done(self) -> bool:
        return (
            not self._pending and not self._active
            and bool(self._landed.all())
            and bool(self._drop_done.all())
            and not self._ready_drops
        )

    @property
    def inflight_bytes(self) -> float:
        """Summed size of the active transfers (weight units)."""
        return self._inflight

    def loads(self) -> np.ndarray:
        """Per-partition committed + reserved load the headroom bound is
        enforced against."""
        return self._base_load + self._reserved

    def refresh_loads(self) -> None:
        """Re-sync the committed-load ledger with the member matrix after an
        external mutation (failover repair copies, row restores)."""
        self._base_load = self.pl.partition_weights()
        self._dirty = True

    # ------------------------------------------------------------- failover
    def on_partition_down(self, p: int) -> None:
        """A transfer endpoint died (the caller has already masked the
        member row): abort its in-flight transfers (bytes wasted, copies
        re-queued at the schedule head in stable order), count its landed
        copies un-landed again, and defer the drops that waited on them."""
        p = int(p)
        self._down.add(p)
        keep: list[_Transfer] = []
        requeue: list[int] = []
        for tr in self._active:
            if tr.dest == p or tr.src == p:
                self.stats["migration_wasted"] += tr.size - tr.remaining
                self.stats["aborted_transfers"] += 1
                self._reserved[tr.dest] -= tr.size
                self._inflight -= tr.size
                requeue.append(tr.idx)
                reg = _obs.registry()
                if reg.active:
                    reg.inc("migration_wasted_total", tr.size - tr.remaining)
                    _obs.tracer().event(
                        "migration.abort", item=tr.item, dest=tr.dest,
                        src=tr.src, moved=tr.size - tr.remaining,
                    )
            else:
                keep.append(tr)
        self._active = keep
        self._pending = sorted(requeue) + self._pending
        # landed copies on p were just masked with the row: they must land
        # again (partition_up restores them without a second transfer)
        masked = np.flatnonzero(self._landed & (self.plan.copy_dest == p))
        if len(masked):
            self._landed[masked] = False
            np.add.at(self._unlanded, self.plan.copy_item[masked], 1)
            # the restore-time re-land will count them again
            self.stats["copies_done"] -= len(masked)
        self.refresh_loads()

    def on_partition_up(self, p: int) -> None:
        """A dead endpoint returned (the caller has already restored its
        saved row): copies that had landed before the failure are live
        again, and their items' deferred drops re-arm."""
        p = int(p)
        self._down.discard(p)
        restored = np.flatnonzero(
            ~self._landed
            & (self.plan.copy_dest == p)
            & self.pl.member[p, self.plan.copy_item]
        )
        for i in restored:
            self._land(int(i), transfer=None)
        self._pending = [i for i in self._pending if i not in set(restored)]
        self.refresh_loads()

    # ----------------------------------------------------------------- tick
    def advance(self, nticks: int) -> None:
        """Advance serving time by ``nticks`` queries, progressing transfers
        at ``bandwidth`` weight-units per tick.  Returns as soon as the
        migration is done — ``now`` stops at the completing tick, so it
        reads as the actual migration duration."""
        for _ in range(int(nticks)):
            if self.done:
                return
            self._step()

    def _step(self) -> None:
        self._run_ready_drops()
        if self._dirty:
            started = self._try_start()
            self._dirty = False
            if (
                not started and not self._active and self._pending
                and not self._down and not self._ready_drops
            ):
                no_src = sorted({
                    int(self.plan.copy_item[idx]) for idx in self._pending
                    if self._pick_source(int(self.plan.copy_item[idx])) < 0
                })
                if no_src:
                    raise RuntimeError(
                        f"migration stalled at tick {self.now}: "
                        f"{len(no_src)} pending items have no live source "
                        f"replica to copy from (e.g. {no_src[:5]}) — "
                        f"plan_migration only validates coverage of the "
                        f"target layout; the live layout must hold every "
                        f"item being copied"
                    )
                raise RuntimeError(
                    f"migration stalled at tick {self.now}: "
                    f"{len(self._pending)} pending copies are blocked and "
                    f"no transfer is active — migration_headroom "
                    f"{self.plan.headroom} is too tight for this diff"
                )
        if not self._active:
            if self._pending:
                self.stats["stall_ticks"] += 1
            self.now += 1
            return
        budget = self.plan.bandwidth
        finished: list[_Transfer] = []
        for tr in self._active:
            if budget <= 0:
                break
            take = min(tr.remaining, budget)
            tr.remaining -= take
            budget -= take
            self.stats["migration_transferred"] += take
            if tr.remaining <= 1e-12:
                finished.append(tr)
        if finished:
            self._active = [tr for tr in self._active if tr.remaining > 1e-12]
            for tr in finished:  # start order == completion order
                self._reserved[tr.dest] -= tr.size
                self._base_load[tr.dest] += tr.size
                self._inflight -= tr.size
                self._land(tr.idx, transfer=tr)
            self._dirty = True  # slots and/or space freed
        reg = _obs.registry()
        if reg.active:
            spent = self.plan.bandwidth - budget
            if spent > 0:
                reg.inc("migration_transferred_total", spent)
            reg.set("migration_inflight", self._inflight)
        self.now += 1

    def _land(self, idx: int, transfer: _Transfer | None) -> None:
        """Copy ``idx`` is live: flip the member bit, emit the event, and
        release the item's drops when it was the last missing copy."""
        dest = int(self.plan.copy_dest[idx])
        v = int(self.plan.copy_item[idx])
        self.pl.member[dest, v] = True
        self._landed[idx] = True
        self._unlanded[v] -= 1
        self.stats["copies_done"] += 1
        reg = _obs.registry()
        if reg.active:
            reg.inc("migration_copies_total")
        if transfer is not None:
            self.events.append(
                TransferEvent(self.now, "copy", dest, v, transfer.src)
            )
            tr_ = _obs.tracer()
            if tr_.active:
                tr_.complete(
                    "migration.transfer", transfer.t0, time.perf_counter(),
                    item=v, dest=dest, src=transfer.src, size=transfer.size,
                    ticks=self.now - transfer.tick0,
                )
        if self._unlanded[v] == 0:
            self._ready_drops.extend(self._drops_of.get(v, ()))
            self._run_ready_drops()

    def _run_ready_drops(self) -> None:
        """Execute released drops whose partition is live; an old replica
        on a down partition keeps its drop deferred (executing it against a
        masked row would resurrect on restore), and an item with ANY copy
        host currently down holds all its drops (the landed copy is masked,
        so the old replica is still load-bearing)."""
        if not self._ready_drops:
            return
        deferred: list[int] = []
        for j in self._ready_drops:
            if self._drop_done[j]:
                # a down/up cycle re-released an item whose drop already ran
                continue
            p = int(self.plan.drop_part[j])
            v = int(self.plan.drop_item[j])
            if p in self._down or self._unlanded[v] > 0:
                deferred.append(j)
                continue
            self.pl.member[p, v] = False
            self._base_load[p] -= float(self._w[v])
            self._drop_done[j] = True
            self.stats["drops_done"] += 1
            _obs.registry().inc("migration_drops_total")
            self.events.append(TransferEvent(self.now, "drop", p, v))
        self._ready_drops = deferred
        self._dirty = True  # drops freed space: retry blocked starts

    def _try_start(self) -> int:
        """First-fit scan of the pending schedule: start every copy whose
        destination is live, under its concurrency cap, and inside the
        headroom bound, with a live source available.  Blocked copies are
        skipped, not head-of-line blocking."""
        if not self._pending:
            return 0
        active_per_dest = np.bincount(
            [tr.dest for tr in self._active],
            minlength=self.plan.num_partitions,
        ) if self._active else np.zeros(self.plan.num_partitions,
                                        dtype=np.int64)
        started = 0
        still: list[int] = []
        for idx in self._pending:
            dest = int(self.plan.copy_dest[idx])
            v = int(self.plan.copy_item[idx])
            if dest in self._down:
                still.append(idx)
                continue
            if self.pl.member[dest, v]:
                # already live (a failover repair beat the transfer to it):
                # no bytes to move, but the landing still gates drops
                self._land(idx, transfer=None)
                started += 1
                continue
            if active_per_dest[dest] >= self.plan.concurrency:
                still.append(idx)
                continue
            wv = float(self._w[v])
            if (self._base_load[dest] + self._reserved[dest] + wv
                    > self._cap[dest] + 1e-9):
                still.append(idx)
                continue
            src = self._pick_source(v)
            if src < 0:
                still.append(idx)
                continue
            tr_ = _obs.tracer()
            self._active.append(_Transfer(
                idx, dest, v, src, wv,
                t0=time.perf_counter() if tr_.active else 0.0,
                tick0=self.now,
            ))
            self._reserved[dest] += wv
            self._inflight += wv
            active_per_dest[dest] += 1
            started += 1
        self._pending = still
        if self._inflight > self.stats["max_inflight"]:
            self.stats["max_inflight"] = self._inflight
        reg = _obs.registry()
        if reg.active:
            reg.set("migration_inflight", self._inflight)
        return started

    def _pick_source(self, v: int) -> int:
        """Lowest-id live partition currently holding ``v`` (the preferred
        plan source when it is alive and still a holder, since the old
        holders precede any landed copies in id order only by accident —
        the live matrix is the single source of truth)."""
        holders = np.flatnonzero(self.pl.member[:, v])
        for p in holders:
            if int(p) not in self._down:
                return int(p)
        return -1
