"""The whole slice, HPA -> LMBR -> replay: ``Simulator.run(lmbr)`` of the
port (on the CPU) against the JAX package's on the same workloads.

The reference runs once with its defaults and once under
``peeldevice+spanrounddevice``; the port runs under the default (vector
peel) and under the same variant (its kernels' plain versions).  Summaries
and member matrices are identical across all four, except ``placement_s``
(wall time) and ``fit_peel`` / ``fit_cover_engine`` (which backend ran);
those two match between reference and port under the same backend."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import flags as ref_flags
from repro.core import Simulator as RefSimulator
from repro.core import lmbr as ref_lmbr
from repro.core.workloads import ispd_like_workload as ref_ispd
from repro.core.workloads import random_workload as ref_random
from repro_torch import flags
from repro_torch.core import (SpanMaintainer, Simulator, batched_cover_csr,
                              from_reference_arrays, hpa_placement, lmbr,
                              peel_counters, random_placement)

jax = pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parents[1]
DEVICE_VARIANT = "peeldevice+spanrounddevice"
BACKEND_KEYS = {"placement_s", "fit_peel", "fit_cover_engine"}


@pytest.fixture(autouse=True)
def _flag_hygiene():
    flags.reset()
    ref_flags.reset()
    yield
    flags.reset()
    ref_flags.reset()


def _ref_run(hg, n, cap, max_moves, variant):
    ref_flags.set_variant(variant)
    members = []

    def fit(*a, **kw):
        pl = ref_lmbr(*a, **kw)
        members.append(pl.member.copy())
        return pl

    res = RefSimulator(n, cap).run(hg, fit, name="lmbr", seed=0,
                                   max_moves=max_moves)
    ref_flags.reset()
    return res.summary(), members[0]


def _port_run(hg, n, cap, max_moves, variant):
    flags.set_variant(variant)
    port_hg = from_reference_arrays(hg.edge_ptr, hg.edge_nodes,
                                    hg.node_weights, hg.edge_weights,
                                    hg.num_nodes)
    res = Simulator(n, cap, device="cpu").run(port_hg, lmbr, seed=0,
                                              max_moves=max_moves)
    flags.reset()
    return res.summary(), res.member


WORKLOADS = {
    "random": (lambda: ref_random(200, 500, density=6, seed=7).hypergraph,
               12, 20, 40),
    "ispd": (lambda: ref_ispd(num_nodes=2000, seed=0).hypergraph,
             35, 100, 60),
}


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_slice_matches_reference(name):
    make, n, cap, max_moves = WORKLOADS[name]
    hg = make()
    runs = {}
    for variant in ("", DEVICE_VARIANT):
        runs["ref", variant] = _ref_run(hg, n, cap, max_moves, variant)
        peel0 = peel_counters()
        runs["port", variant] = _port_run(hg, n, cap, max_moves, variant)
        peel1 = peel_counters()
        if variant:
            assert peel1["dense_pairs"] > peel0["dense_pairs"]
    base_summary, base_member = runs["ref", ""]
    assert base_summary["fit_moves"] > 0
    for key, (summary, member) in runs.items():
        assert set(summary) == set(base_summary), key
        diff = {k for k in summary
                if k not in BACKEND_KEYS and summary[k] != base_summary[k]}
        assert not diff, (key, diff)
        np.testing.assert_array_equal(member, base_member, err_msg=str(key))
    for variant in ("", DEVICE_VARIANT):
        ref_s, port_s = runs["ref", variant][0], runs["port", variant][0]
        for k in ("fit_peel", "fit_cover_engine"):
            assert port_s[k] == ref_s[k], (variant, k)
    assert runs["port", DEVICE_VARIANT][0]["fit_peel"] == "device"
    assert runs["port", DEVICE_VARIANT][0]["fit_cover_engine"][
        "device_buckets"] > 0


@pytest.mark.parametrize("algo", ["random", "hpa"])
def test_baselines_match_reference(algo):
    from repro.core import hpa_placement as ref_hpa_pl
    from repro.core import random_placement as ref_random_pl

    hg = ref_random(200, 500, density=6, seed=7).hypergraph
    port_hg = from_reference_arrays(hg.edge_ptr, hg.edge_nodes,
                                    hg.node_weights, hg.edge_weights,
                                    hg.num_nodes)
    ref_fn, fn = ((ref_random_pl, random_placement) if algo == "random"
                  else (ref_hpa_pl, hpa_placement))
    want = RefSimulator(12, 20).run(hg, ref_fn, seed=3).summary()
    got = Simulator(12, 20, device="cpu").run(port_hg, fn, seed=3).summary()
    want.pop("placement_s")
    got.pop("placement_s")
    assert got == want


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "from repro_torch.core import Simulator, lmbr, random_workload\n"
        "from repro_torch import flags\n"
        "flags.set_variant('peeldevice+spanrounddevice')\n"
        "hg = random_workload(60, 120, density=4, seed=1).hypergraph\n"
        "res = Simulator(6, 14, device='cpu').run(hg, lmbr, max_moves=10)\n"
        "assert res.summary()['fit_peel'] == 'device'\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print('LEAKED', bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout


def test_package_sources_have_no_jax_reference_or_silent_fallback():
    pkg = ROOT / "src" / "repro_torch"
    for path in pkg.rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text, path
        assert "from repro." not in text and "import repro\n" not in text, path
        assert "from repro import" not in text, path
        assert "except Exception" not in text, path


def test_cuda_default_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Simulator(12, 20, device=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Simulator(12, 20)
    hg = ref_random(30, 40, density=3, seed=0).hypergraph
    port_hg = from_reference_arrays(hg.edge_ptr, hg.edge_nodes, None, None,
                                    hg.num_nodes)
    member = np.ones((2, 30), dtype=bool)
    with pytest.raises(RuntimeError):
        batched_cover_csr(port_hg.edge_ptr, port_hg.edge_nodes, member)
    with pytest.raises(RuntimeError):
        lmbr(port_hg, 4, 20.0)
    from repro_torch.core import Placement
    with pytest.raises(RuntimeError):
        SpanMaintainer(port_hg, Placement.from_member(member, 1e9))
    # an explicit CPU device still runs
    assert batched_cover_csr(port_hg.edge_ptr, port_hg.edge_nodes, member,
                             device="cpu").spans.max() == 1
