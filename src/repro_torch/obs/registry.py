"""Metrics registry: counters, gauges, and fixed-bucket histograms.

One process-wide ``Registry`` (owned by ``repro_torch.obs``) holds every
instrument keyed by ``(name, sorted label items)``.  Instruments are
plain-Python accumulators — no locks, no background threads — because the
whole repo is single-process and the hot paths only touch them behind an
``registry().active`` check.

``snapshot()`` flattens the registry into a ``{series_id: value}`` dict in
Prometheus exposition naming (``name{label="v"}``, histogram ``_bucket`` /
``_sum`` / ``_count`` series), ``to_prom_text()`` renders the text
exposition format, and ``parse_prom_text()`` parses it back — the pair
round-trips exactly (``parse_prom_text(to_prom_text()) == snapshot()``).
This is a copy of the JAX package's registry.

The ``NULL_REGISTRY`` singleton implements the same surface as no-ops with
``active = False``; hot paths hold zero instruments and allocate nothing
while ``flags.obs_level == "off"``.
"""

from __future__ import annotations

from bisect import bisect_left

__all__ = [
    "Counter", "Gauge", "GaugeVector", "Histogram", "Registry",
    "NullRegistry", "NULL_REGISTRY", "DEFAULT_BUCKETS", "parse_prom_text",
]

# default latency buckets, in seconds (upper bounds; +Inf is implicit).
DEFAULT_BUCKETS = (
    100e-6, 250e-6, 500e-6, 1e-3, 2.5e-3, 5e-3, 10e-3, 25e-3, 50e-3,
    100e-3, 250e-3, 500e-3, 1.0, 2.5,
)


class Counter:
    """Monotonically increasing accumulator."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0):
        self.value += n


class Gauge:
    """Scalar that can move both ways."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float):
        self.value = float(v)

    def add(self, n: float):
        self.value += n


class GaugeVector:
    """Indexed gauge family (one series per element, label index="i").

    ``set()`` keeps a reference to the given sequence; values are copied
    out lazily at snapshot time, so hot paths pay one attribute store per
    update (e.g. the router's per-partition load ledger).
    """

    __slots__ = ("values",)

    def __init__(self):
        self.values = ()

    def set(self, values):
        self.values = values


class Histogram:
    """Fixed-bucket histogram (cumulative le-buckets at snapshot time)."""

    __slots__ = ("uppers", "counts", "sum", "count")

    def __init__(self, buckets=DEFAULT_BUCKETS):
        self.uppers = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.uppers) + 1)  # last slot = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, x: float):
        self.counts[bisect_left(self.uppers, x)] += 1
        self.sum += x
        self.count += 1


def _series_id(name: str, labels) -> str:
    if not labels:
        return name
    inner = ",".join(f'{k}="{_escape(str(v))}"' for k, v in labels)
    return f"{name}{{{inner}}}"


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _fmt(upper: float) -> str:
    """Bucket upper bound formatted for the le label (round-trippable)."""
    return repr(upper)


class Registry:
    """Process-wide instrument store.  See module docstring."""

    active = True

    def __init__(self):
        self._metrics: dict = {}   # (name, labels tuple) -> instrument
        self._kinds: dict = {}     # name -> "counter" | "gauge" | ...

    # -- instrument accessors (get-or-create) ---------------------------
    def counter(self, name: str, **labels) -> Counter:
        return self._get(name, "counter", Counter, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(name, "gauge", Gauge, labels)

    def gauge_vector(self, name: str, **labels) -> GaugeVector:
        return self._get(name, "gauge", GaugeVector, labels)

    def histogram(self, name: str, buckets=DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._get(name, "histogram", lambda: Histogram(buckets),
                         labels)

    def _get(self, name, kind, factory, labels):
        prev = self._kinds.setdefault(name, kind)
        if prev != kind:
            raise ValueError(
                f"metric {name!r} already registered as {prev}, not {kind}"
            )
        key = (name, tuple(sorted(labels.items())))
        inst = self._metrics.get(key)
        if inst is None:
            inst = self._metrics[key] = factory()
        return inst

    # -- convenience one-shots ------------------------------------------
    def inc(self, name: str, n: float = 1.0, **labels):
        self.counter(name, **labels).inc(n)

    def set(self, name: str, v: float, **labels):
        self.gauge(name, **labels).set(v)

    def observe(self, name: str, x: float, **labels):
        self.histogram(name, **labels).observe(x)

    # -- export ----------------------------------------------------------
    def snapshot(self) -> dict:
        """Flat ``{prom series id: float value}`` view of every instrument."""
        out: dict = {}
        for (name, labels), inst in self._metrics.items():
            if isinstance(inst, (Counter, Gauge)):
                out[_series_id(name, labels)] = float(inst.value)
            elif isinstance(inst, GaugeVector):
                for i, v in enumerate(inst.values):
                    out[_series_id(name, labels + (("index", i),))] = float(v)
            else:  # Histogram
                cum = 0
                for upper, c in zip(inst.uppers, inst.counts):
                    cum += c
                    lb = labels + (("le", _fmt(upper)),)
                    out[_series_id(name + "_bucket", lb)] = float(cum)
                lb = labels + (("le", "+Inf"),)
                out[_series_id(name + "_bucket", lb)] = float(inst.count)
                out[_series_id(name + "_sum", labels)] = float(inst.sum)
                out[_series_id(name + "_count", labels)] = float(inst.count)
        return out

    def to_prom_text(self) -> str:
        """Prometheus text exposition of the full registry."""
        lines: list = []
        seen: set = set()
        for (name, _labels) in self._metrics:
            if name not in seen:
                seen.add(name)
                lines.append(f"# TYPE {name} {self._kinds[name]}")
        for series, value in sorted(self.snapshot().items()):
            lines.append(f"{series} {value!r}")
        return "\n".join(lines) + ("\n" if lines else "")

    def clear(self):
        self._metrics.clear()
        self._kinds.clear()


def parse_prom_text(text: str) -> dict:
    """Parse ``to_prom_text()`` output back into a ``snapshot()`` dict."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        series, _, value = line.rpartition(" ")
        out[series] = float(value)
    return out


class _NullInstrument:
    """Accepts every instrument mutation as a no-op."""

    __slots__ = ()

    def inc(self, n: float = 1.0):
        pass

    def set(self, v):
        pass

    def add(self, n: float):
        pass

    def observe(self, x: float):
        pass


_NULL_INSTRUMENT = _NullInstrument()


class NullRegistry:
    """No-op stand-in for ``Registry`` when ``obs_level == "off"``.

    Every accessor returns the shared ``_NullInstrument`` singleton, so
    instrumented hot paths allocate nothing and store nothing.
    """

    active = False

    def counter(self, name: str, **labels):
        return _NULL_INSTRUMENT

    def gauge(self, name: str, **labels):
        return _NULL_INSTRUMENT

    def gauge_vector(self, name: str, **labels):
        return _NULL_INSTRUMENT

    def histogram(self, name: str, buckets=DEFAULT_BUCKETS, **labels):
        return _NULL_INSTRUMENT

    def inc(self, name: str, n: float = 1.0, **labels):
        pass

    def set(self, name: str, v: float, **labels):
        pass

    def observe(self, name: str, x: float, **labels):
        pass

    def snapshot(self) -> dict:
        return {}

    def to_prom_text(self) -> str:
        return ""

    def clear(self):
        pass


NULL_REGISTRY = NullRegistry()
