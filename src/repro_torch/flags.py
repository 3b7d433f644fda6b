"""Knobs of the placement pipeline (HPA -> LMBR -> replay).

A cut-down copy of the JAX package's flag table holding only the keys this
package reads.  Defaults are the reference's; the two span thresholds were
calibrated on a CPU host and have not been re-measured on a GPU yet.

Backend values:

* ``span_backend``: ``"auto"`` (per greedy round: numpy below
  ``span_dispatch_threshold`` gain words, the span_gain kernel above it),
  ``"numpy"``, ``"device"``.
* ``span_round_backend``: ``"auto"`` (per word-count bucket: the host round
  loop below ``span_round_threshold`` packed words, the cover_rounds kernel
  above it), ``"numpy"``, ``"device"``.
* ``lmbr_peel``: ``"vector"`` (flat numpy lockstep), ``"reference"``
  (pure-Python oracle), ``"auto"`` (oracle for narrow pairs, vector for the
  rest), ``"device"`` (the lockstep_peel kernel).

``"device"`` means the CUDA kernel when the caller's device is a GPU and the
kernel's plain PyTorch version when it is the CPU.  Every backend is
bit-identical, so these are performance knobs only.
"""

from __future__ import annotations

_DEFAULTS = dict(
    span_backend="auto",
    span_dispatch_threshold=48_000,
    span_round_backend="auto",
    span_round_threshold=200_000,
    lmbr_peel="vector",
    lmbr_peel_threshold=256,
    lmbr_gain_cache=True,
    lmbr_epochs="item",
    placement_objective="span",
    node_cost_weight=0.0,
    obs_level="off",
)

FLAGS = dict(_DEFAULTS)

SPAN_BACKENDS = ("auto", "numpy", "device")
SPAN_ROUND_BACKENDS = ("auto", "numpy", "device")
PEEL_BACKENDS = ("vector", "reference", "auto", "device")


def set_variant(spec: str):
    """'peeldevice+spanrounddevice+spanth1000' -> flag settings."""
    reset()
    for part in filter(None, spec.split("+")):
        if part == "baseline":
            continue
        elif part.startswith("spanth"):
            FLAGS["span_dispatch_threshold"] = int(part[len("spanth"):])
        elif part.startswith("spanroundth"):
            FLAGS["span_round_threshold"] = int(part[len("spanroundth"):])
        elif part.startswith("spanround"):
            backend = part[len("spanround"):]
            if backend not in SPAN_ROUND_BACKENDS:
                raise ValueError(f"unknown span round backend {backend!r}")
            FLAGS["span_round_backend"] = backend
        elif part.startswith("peelth"):
            FLAGS["lmbr_peel_threshold"] = int(part[len("peelth"):])
        elif part.startswith("peel"):
            backend = part[len("peel"):]
            if backend not in PEEL_BACKENDS:
                raise ValueError(f"unknown lmbr peel backend {backend!r}")
            FLAGS["lmbr_peel"] = backend
        elif part.startswith("lmbrepoch"):
            mode = part[len("lmbrepoch"):]
            if mode not in ("item", "partition"):
                raise ValueError(f"unknown lmbr epoch mode {mode!r}")
            FLAGS["lmbr_epochs"] = mode
        elif part.startswith("lmbrcache"):
            FLAGS["lmbr_gain_cache"] = bool(int(part[len("lmbrcache"):]))
        elif part == "energy":
            FLAGS["placement_objective"] = "energy"
        elif part.startswith("nodecost"):
            w = float(part[len("nodecost"):])
            if w < 0:
                raise ValueError(f"node_cost_weight must be >= 0, got {w}")
            FLAGS["node_cost_weight"] = w
        elif part.startswith("obs"):
            lv = part[len("obs"):]
            if lv not in ("off", "counters", "trace"):
                raise ValueError(f"unknown obs level {lv!r}")
            FLAGS["obs_level"] = lv
        elif part.startswith("span"):
            backend = part[len("span"):]
            if backend not in SPAN_BACKENDS:
                raise ValueError(f"unknown span backend {backend!r}")
            FLAGS["span_backend"] = backend
        else:
            raise ValueError(f"unknown variant component {part!r}")


def reset():
    FLAGS.clear()
    FLAGS.update(_DEFAULTS)
