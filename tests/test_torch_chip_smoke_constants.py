"""``chip_smoke.py``'s paper-algos table against the JAX package: every
row's avg_span is what the reference's ``Simulator.run`` gives on the CPU,
and the port's workload generators build the reference's hypergraphs, so
the card run is held to the reference without importing it."""

import sys
from pathlib import Path

import pytest

from repro.core import ALGORITHMS as REF_ALGORITHMS
from repro.core import Simulator as RefSimulator
from repro.core import workloads as ref_workloads
from repro_torch.core import workloads

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

sys.path.remove(str(ROOT))

_GRAPHS = {}


def _ref_graph(key):
    if key not in _GRAPHS:
        fn, kw = chip_smoke.PAPER_WORKLOADS[key]
        _GRAPHS[key] = getattr(ref_workloads, fn)(**kw).hypergraph
    return _GRAPHS[key]


def test_table_covers_every_algorithm_at_both_points():
    runs = {(w, n, name) for w, n, _, name, _, _ in chip_smoke.PAPER_RUNS}
    assert len(runs) == len(chip_smoke.PAPER_RUNS)
    for w, n in (("fig6", 40), ("fig9-ibm01", 35)):
        assert {name for w_, n_, name in runs if (w_, n_) == (w, n)} \
            == set(REF_ALGORITHMS)
    assert ("fig6", 30, "ihpa") in runs
    assert "paper-algos" in chip_smoke.PHASES


@pytest.mark.parametrize("key", list(chip_smoke.PAPER_WORKLOADS))
def test_port_generators_build_the_reference_graphs(key):
    fn, kw = chip_smoke.PAPER_WORKLOADS[key]
    got = getattr(workloads, fn)(**kw).hypergraph
    want = _ref_graph(key)
    for name in ("edge_ptr", "edge_nodes", "node_weights", "edge_weights"):
        assert getattr(got, name).tobytes() == getattr(want, name).tobytes()


@pytest.mark.parametrize(
    "row", chip_smoke.PAPER_RUNS,
    ids=[f"{w}-{n}-{name}" for w, n, _, name, _, _ in chip_smoke.PAPER_RUNS])
def test_reference_avg_span(row):
    workload, n, cap, name, extra, want = row
    res = RefSimulator(n, cap).run(_ref_graph(workload), REF_ALGORITHMS[name],
                                   name=name, seed=0, **extra)
    assert res.avg_span == want
