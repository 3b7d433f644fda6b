"""lockstep_peel: the port's plain PyTorch version (what the wrapper runs on
CPU tensors) against the JAX package's f64 numpy oracle and its Pallas
kernel in interpret mode, on the same seeded integer-weight batches.  On
that domain every trajectory value is an integer f32 holds exactly, so
every comparison is exact."""

import numpy as np
import pytest
import torch

from repro.kernels.lockstep_peel.ops import lockstep_peel as ref_peel
from repro_torch.kernels.lockstep_peel.ops import (lockstep_peel,
                                                    lockstep_peel_plain)

jax = pytest.importorskip("jax")


def _instance(G, K, U, seed):
    """Random integer-weight batch, zero beyond each pair's nvalid prefix."""
    rng = np.random.default_rng(seed)
    inc = np.zeros((G, K, U), dtype=np.float64)
    nvalid = rng.integers(1, U + 1, size=G).astype(np.int64)
    for g in range(G):
        u = int(nvalid[g])
        for k in range(K):
            pins = np.unique(rng.integers(0, u, size=int(rng.integers(1, 5))))
            inc[g, k, pins] = 1.0
    we = rng.integers(1, 9, size=(G, K)).astype(np.float64)
    nodew = np.zeros((G, U), dtype=np.float64)
    for g in range(G):
        nodew[g, : nvalid[g]] = rng.integers(1, 5, size=int(nvalid[g]))
    return inc, we, nodew, nvalid


def _port(inc, we, nodew, nvalid):
    got = lockstep_peel(
        torch.from_numpy(inc.astype(np.float32)),
        torch.from_numpy(we.astype(np.float32)),
        torch.from_numpy(nodew.astype(np.float32)),
        torch.from_numpy(nvalid.astype(np.int32)),
    )
    peel, rtot, rben = (t.numpy() for t in got)
    assert peel.dtype == np.int32 and rtot.dtype == np.float32
    return (peel.astype(np.int64), rtot.astype(np.float64),
            rben.astype(np.float64))


SHAPES = [(1, 1, 1), (3, 4, 7), (7, 13, 21), (5, 9, 130), (2, 17, 3),
          (4, 64, 16)]


@pytest.mark.parametrize("force", ["numpy", "interpret"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_reference(shape, force):
    G, K, U = shape
    inst = _instance(G, K, U, seed=G * 1000 + K * 10 + U)
    want = ref_peel(*inst, force=force)
    got = _port(*inst)
    for w, g, name in zip(want, got, ("peel", "rtot", "rben")):
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=f"{force}:{name}")


def test_trajectory_semantics():
    # two items, one edge of weight 3 over both: item 0 (lower slot) is
    # peeled first on the degree tie, the edge dies, the pair stops
    inc = np.array([[[1.0, 1.0]]])
    we = np.array([[3.0]])
    nodew = np.array([[2.0, 5.0]])
    nvalid = np.array([2])
    peel, rtot, rben = _port(inc, we, nodew, nvalid)
    np.testing.assert_array_equal(peel, [[0, -1]])
    np.testing.assert_array_equal(rtot, [[7.0, 0.0]])
    np.testing.assert_array_equal(rben, [[3.0, 0.0]])


def test_cpu_tensors_run_the_plain_version():
    inst = _instance(2, 3, 4, seed=0)
    args = [torch.from_numpy(a.astype(t)) for a, t in
            zip(inst, (np.float32, np.float32, np.float32, np.int32))]
    before = lockstep_peel.launches
    for a, b in zip(lockstep_peel(*args), lockstep_peel_plain(*args)):
        assert torch.equal(a, b)
    assert lockstep_peel.launches == before


def test_wrapper_rejects_bad_inputs():
    inc = torch.zeros((1, 2, 3))
    with pytest.raises(TypeError):
        lockstep_peel(inc.double(), torch.zeros((1, 2)), torch.zeros((1, 3)),
                      torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        lockstep_peel(inc, torch.zeros((1, 3)), torch.zeros((1, 3)),
                      torch.ones(1, dtype=torch.int32))

