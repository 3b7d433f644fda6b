"""Straggler detection: per-host latency EWMA against the fleet median
(the reference's ``runtime/straggler.py``).

A host whose smoothed latency exceeds ``threshold`` times the fleet
median is flagged; the caller re-covers its work from replicas (the
paper's replica selection)."""

from __future__ import annotations

import numpy as np

__all__ = ["StragglerDetector"]


class StragglerDetector:
    def __init__(self, num_hosts: int, alpha: float = 0.3,
                 threshold: float = 3.0, min_samples: int = 5):
        self.ewma = np.zeros(num_hosts)
        self.count = np.zeros(num_hosts, dtype=np.int64)
        self.alpha = alpha
        self.threshold = threshold
        self.min_samples = min_samples

    def observe(self, host: int, seconds: float) -> bool:
        """Returns True when ``host`` should be treated as a straggler."""
        if self.count[host] == 0:
            self.ewma[host] = seconds
        else:
            self.ewma[host] = (
                self.alpha * seconds + (1 - self.alpha) * self.ewma[host]
            )
        self.count[host] += 1
        seen = self.count >= 1
        if self.count[host] < self.min_samples or seen.sum() < 3:
            return False
        med = float(np.median(self.ewma[seen]))
        return bool(self.ewma[host] > self.threshold * max(med, 1e-9))
