"""lockstep_peel: the port's plain PyTorch version (what the wrapper runs on
CPU tensors) against the JAX package's f64 numpy oracle and its Pallas
kernel in interpret mode, on the same seeded integer-weight batches.  On
that domain every trajectory value is an integer f32 holds exactly, so
every comparison is exact."""

import numpy as np
import pytest
import torch

from repro.kernels.lockstep_peel.ops import lockstep_peel as ref_peel
from repro_torch.kernels.lockstep_peel.ops import (WARP_MAX_K, WARP_MAX_U,
                                                    lockstep_peel,
                                                    lockstep_peel_plain,
                                                    uses_shared_memory)

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


def _assert_matches(inst, force):
    want = ref_peel(*inst, force=force)
    got = _port(*inst)
    for w, g, name in zip(want, got, ("peel", "rtot", "rben")):
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=f"{force}:{name}")
    return got


# the (K, U) classes LMBR's dense peel launches most (K 128 / 64 with U 64
# / 32), a cell of the real K and U (100, 49), and U > 64 not a multiple
# of 32 (three full lane words and one partial)
PATH_SHAPES = [(3, 128, 64), (2, 64, 32), (1, 100, 49), (2, 40, 97)]


@pytest.mark.parametrize("force", ["numpy", "interpret"])
@pytest.mark.parametrize("shape", PATH_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_reference_path_classes(shape, force):
    G, K, U = shape
    _assert_matches(_instance(G, K, U, seed=7 * G + 3 * K + U), force)


def _tie_instance(G, K, U):
    """Equal weights over a regular incidence: pair g's edge k holds slots
    k mod U and (k + 1 + g) mod U, so every degree starts equal and most
    rounds are decided by the lowest-slot rule."""
    inc = np.zeros((G, K, U), dtype=np.float64)
    for g in range(G):
        for k in range(K):
            inc[g, k, k % U] = 1.0
            inc[g, k, (k + 1 + g) % U] = 1.0
    return (inc, np.ones((G, K)), np.ones((G, U)),
            np.full(G, U, dtype=np.int64))


@pytest.mark.parametrize("force", ["numpy", "interpret"])
def test_plain_matches_reference_on_ties(force):
    inst = _tie_instance(3, 64, 32)
    peel, _, _ = _assert_matches(inst, force)
    # the instance is tie-decided: peeling over the slots in reverse order
    # (ties -> highest slot) gives another trajectory
    inc, we, nodew, nvalid = inst
    rev, _, _ = _port(inc[:, :, ::-1].copy(), we, nodew[:, ::-1].copy(),
                      nvalid)
    rev = np.where(rev >= 0, inc.shape[2] - 1 - rev, rev)
    assert (peel >= 0).sum() > 30
    assert not np.array_equal(rev, peel)


@pytest.mark.parametrize("force", ["numpy", "interpret"])
def test_plain_matches_reference_on_early_stops(force):
    G, K, U = 3, 8, 40
    inc, we, nodew, nvalid = _instance(G, K, U, seed=11)
    nvalid[:] = U
    nodew[:] = 2.0
    # pair 0: edge k holds slots 5k .. 5k + 4, so each edge's death leaves
    # four items of degree 0 that go next, and the benefit reaches 0 when
    # the last edge loses its first pin, with four items left; pair 1:
    # edges 2..4 hold only slots beyond nvalid, never die, and the pair
    # runs until its valid items run out; pair 2: every edge weighs 0
    inc[0] = 0.0
    for k in range(K):
        inc[0, k, 5 * k: 5 * k + 5] = 1.0
    nvalid[1] = U - 4
    nodew[1, U - 4:] = 0.0
    inc[1, 2:5] = 0.0
    inc[1, 2:5, U - 4:] = 1.0
    we[2] = 0.0
    peel, rtot, rben = _assert_matches((inc, we, nodew, nvalid), force)
    rounds = (peel >= 0).sum(axis=1)
    assert rounds[0] == 5 * (K - 1) + 1
    assert rounds[1] == U - 4
    assert rounds[2] == 0 and (rtot[2] == 0).all() and (rben[2] == 0).all()


def test_size_class_edges():
    assert (WARP_MAX_K, WARP_MAX_U) == (256, 256)
    for K, U in ((0, 1), (1, 1), (128, 64), (256, 64), (128, 256),
                 (256, 256), (101, 97), (256, 1), (1, 256)):
        assert uses_shared_memory(K, U), (K, U)
    for K, U in ((257, 256), (256, 257), (1024, 64), (8192, 512),
                 (65536, 64), (4, 1 << 20)):
        assert not uses_shared_memory(K, U), (K, U)
    # of the pow2 classes the dispatcher forms (u2 k2 <= 2^22, both >= 4),
    # exactly those with K <= 256 and U <= 256 are in the warp class
    for ku in range(2, 21):
        for uu in range(2, 23 - ku):
            K, U = 1 << ku, 1 << uu
            assert uses_shared_memory(K, U) == (K <= 256 and U <= 256)


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
    classes = dict(lockstep_peel.class_launches)
    for a, b in zip(lockstep_peel(*args), lockstep_peel_plain(*args)):
        assert torch.equal(a, b)
    assert lockstep_peel.launches == before
    assert lockstep_peel.class_launches == classes


def test_wrapper_rejects_bad_inputs():
    inc = torch.zeros((1, 2, 3))
    with pytest.raises(TypeError):
        lockstep_peel(inc.double(), torch.zeros((1, 2)), torch.zeros((1, 3)),
                      torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError):
        lockstep_peel(inc, torch.zeros((1, 3)), torch.zeros((1, 3)),
                      torch.ones(1, dtype=torch.int32))

