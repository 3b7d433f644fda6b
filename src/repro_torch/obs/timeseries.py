"""Fixed-capacity time-series store over registry snapshots.

The metrics `Registry` is a point-in-time view: counters only ever hold
their latest value.  `TimeSeriesStore` turns the periodic
``run_online`` snapshots (``obs_snapshot_every``) into bounded history —
one ring buffer per series id — and exposes the windowed aggregations the
health monitor's SLO rules consume:

* ``delta(name, n)`` / ``rate(name, n)`` — counter movement over the last
  ``n`` samples (rate per unit of the ingest time axis; ``run_online``
  feeds served-query counts as ``t``, so rates are per query and fully
  deterministic).
* ``mean`` / ``vmin`` / ``vmax`` / ``last`` — gauge aggregations over the
  window.
* ``ewma(name, alpha)`` — exponentially weighted mean over the ring.
* ``vector_delta(base, n)`` — per-index window delta of a ``GaugeVector``
  family (series ``base{index="i"}``), e.g. the router's per-partition
  load ledger, for skew rules.
* ``histogram_quantile(name, q, n)`` — quantile from the windowed DELTA of
  a cumulative ``_bucket`` family (Prometheus-style linear interpolation
  inside the bucket; a quantile landing in the ``+Inf`` bucket reports the
  highest finite bound), e.g. p99 of ``router_microbatch_seconds``.

Ring buffers are preallocated float64 pairs; ``ingest`` appends every
series of a snapshot at one time coordinate, so the store's cost is
O(series) per snapshot and capped by ``capacity`` per series forever.

A copy of the JAX package's ``obs/timeseries.py`` (host numpy; nothing
here touches a device).
"""

from __future__ import annotations

import re

import numpy as np

__all__ = ["SeriesRing", "TimeSeriesStore"]

_INDEX_RE = re.compile(r'^(?P<base>[^{]+)\{index="(?P<i>\d+)"\}$')
_BUCKET_RE = re.compile(r'^(?P<base>[^{]+)_bucket\{(?:.*?)le="(?P<le>[^"]+)"\}$')


class SeriesRing:
    """One series' bounded history: parallel (t, v) float64 rings."""

    __slots__ = ("capacity", "_t", "_v", "_pos", "count")

    def __init__(self, capacity: int):
        if capacity < 2:
            raise ValueError(f"ring capacity must be >= 2, got {capacity}")
        self.capacity = int(capacity)
        self._t = np.zeros(self.capacity, dtype=np.float64)
        self._v = np.zeros(self.capacity, dtype=np.float64)
        self._pos = 0      # next write slot
        self.count = 0     # samples held (saturates at capacity)

    def __len__(self) -> int:
        return self.count

    def append(self, t: float, v: float) -> None:
        self._t[self._pos] = t
        self._v[self._pos] = v
        self._pos = (self._pos + 1) % self.capacity
        if self.count < self.capacity:
            self.count += 1

    def _window(self, arr: np.ndarray, n: int | None) -> np.ndarray:
        k = self.count if n is None else min(int(n), self.count)
        if k <= 0:
            return np.zeros(0, dtype=np.float64)
        # chronological: the k samples ending at the last write
        idx = (self._pos - k + np.arange(k)) % self.capacity
        return arr[idx]

    def values(self, n: int | None = None) -> np.ndarray:
        """Last ``n`` values (all held samples when ``n`` is None),
        oldest first."""
        return self._window(self._v, n)

    def times(self, n: int | None = None) -> np.ndarray:
        return self._window(self._t, n)

    def last(self) -> float:
        if not self.count:
            raise ValueError("empty series")
        return float(self._v[(self._pos - 1) % self.capacity])


class TimeSeriesStore:
    """Ring-buffered history of registry snapshots; see module docstring."""

    def __init__(self, capacity: int = 512):
        self.capacity = int(capacity)
        self._series: dict[str, SeriesRing] = {}

    # ------------------------------------------------------------- recording
    def record(self, name: str, t: float, value: float) -> None:
        ring = self._series.get(name)
        if ring is None:
            ring = self._series[name] = SeriesRing(self.capacity)
        ring.append(float(t), float(value))

    def ingest(self, snapshot: dict, t: float) -> None:
        """Append every series of a ``Registry.snapshot()`` at time ``t``."""
        for name, value in snapshot.items():
            self.record(name, t, value)

    # ------------------------------------------------------------- accessors
    def __contains__(self, name: str) -> bool:
        return name in self._series

    def names(self) -> list[str]:
        return sorted(self._series)

    def series(self, name: str) -> SeriesRing | None:
        return self._series.get(name)

    def window(self, name: str, n: int | None = None) -> np.ndarray:
        ring = self._series.get(name)
        return ring.values(n) if ring is not None else np.zeros(0)

    # ---------------------------------------------------------- aggregations
    def last(self, name: str) -> float | None:
        ring = self._series.get(name)
        return ring.last() if ring is not None and ring.count else None

    def delta(self, name: str, n: int) -> float | None:
        """value[last] - value[first] over the last ``n`` samples; None
        until the series holds at least two samples."""
        ring = self._series.get(name)
        if ring is None or ring.count < 2:
            return None
        v = ring.values(n)
        return float(v[-1] - v[0])

    def rate(self, name: str, n: int = 2) -> float | None:
        """delta / elapsed-time over the last ``n`` samples (per unit of
        the ingest time axis); None without two samples or zero elapsed."""
        ring = self._series.get(name)
        if ring is None or ring.count < 2:
            return None
        v, t = ring.values(n), ring.times(n)
        dt = float(t[-1] - t[0])
        if dt <= 0:
            return None
        return float(v[-1] - v[0]) / dt

    def mean(self, name: str, n: int | None = None) -> float | None:
        v = self.window(name, n)
        return float(v.mean()) if len(v) else None

    def vmin(self, name: str, n: int | None = None) -> float | None:
        v = self.window(name, n)
        return float(v.min()) if len(v) else None

    def vmax(self, name: str, n: int | None = None) -> float | None:
        v = self.window(name, n)
        return float(v.max()) if len(v) else None

    def ewma(self, name: str, alpha: float = 0.3,
             n: int | None = None) -> float | None:
        """Exponentially weighted mean over the (windowed) ring, newest
        sample weighted ``alpha``."""
        v = self.window(name, n)
        if not len(v):
            return None
        acc = float(v[0])
        for x in v[1:]:
            acc = alpha * float(x) + (1.0 - alpha) * acc
        return acc

    # ----------------------------------------------------- vector / histogram
    def vector_delta(self, base: str, n: int) -> np.ndarray:
        """Per-index window delta of the gauge-vector family
        ``base{index="i"}``, ordered by index.  Indices whose series hold
        fewer than two samples (e.g. a partition that appeared mid-window)
        contribute 0."""
        rows: list[tuple[int, float]] = []
        prefix = base + "{"
        for name, ring in self._series.items():
            if not name.startswith(prefix):
                continue
            m = _INDEX_RE.match(name)
            if m is None or m.group("base") != base:
                continue
            d = self.delta(name, n)
            rows.append((int(m.group("i")), 0.0 if d is None else d))
        if not rows:
            return np.zeros(0, dtype=np.float64)
        rows.sort()
        out = np.zeros(rows[-1][0] + 1, dtype=np.float64)
        for i, d in rows:
            out[i] = d
        return out

    def histogram_quantile(self, base: str, q: float,
                           n: int | None = None) -> float | None:
        """Quantile from the windowed delta of the cumulative bucket family
        ``base_bucket{le="..."}``.

        With ``n`` None the latest cumulative counts are used (whole-run
        quantile); otherwise the per-bucket delta over the last ``n``
        samples (windowed quantile).  Linear interpolation inside the
        bucket, Prometheus-style: below the first bound interpolates from
        0, and a quantile landing in the ``+Inf`` bucket reports the
        highest finite bound.  None when the window saw no observations.
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        uppers: list[float] = []
        counts: list[float] = []
        inf_count: float | None = None
        for name, ring in self._series.items():
            m = _BUCKET_RE.match(name)
            if m is None or m.group("base") != base:
                continue
            if n is None:
                c = ring.last() if ring.count else None
            else:
                c = self.delta(name, n)
            if c is None:
                continue
            le = m.group("le")
            if le == "+Inf":
                inf_count = float(c)
            else:
                uppers.append(float(le))
                counts.append(float(c))
        if inf_count is None and not uppers:
            return None
        order = np.argsort(uppers)
        ub = np.asarray(uppers, dtype=np.float64)[order]
        cum = np.asarray(counts, dtype=np.float64)[order]
        total = inf_count if inf_count is not None else (
            float(cum[-1]) if len(cum) else 0.0
        )
        if total <= 0:
            return None
        target = q * total
        prev_cum, prev_ub = 0.0, 0.0
        for u, c in zip(ub, cum):
            if c >= target:
                span = c - prev_cum
                if span <= 0:
                    return float(u)
                frac = (target - prev_cum) / span
                return float(prev_ub + (u - prev_ub) * frac)
            prev_cum, prev_ub = float(c), float(u)
        # target falls in the +Inf bucket: report the highest finite bound
        return float(ub[-1]) if len(ub) else None
