"""cover_rounds: the port's whole-bucket greedy round loop (plain PyTorch
version on CPU tensors) against the JAX package's jitted
``_device_cover_rounds`` on jax-CPU, on the same seeded packed buckets.
Chosen partitions are integers, so every comparison is exact."""

import numpy as np
import pytest
import torch

from repro import flags as ref_flags
from repro.core.hypergraph import Hypergraph as RefHypergraph
from repro.core.setcover import _device_cover_rounds as ref_device_rounds
from repro.core.setcover import batched_cover_csr as ref_batched_cover
from repro_torch import flags
from repro_torch.core import batched_cover_csr, from_reference_arrays
from repro_torch.kernels.cover_rounds.ops import (cover_rounds,
                                                   cover_rounds_plain)

jax = pytest.importorskip("jax")


@pytest.fixture(autouse=True)
def _flag_hygiene():
    flags.reset()
    ref_flags.reset()
    yield
    flags.reset()
    ref_flags.reset()


def _bucket(B, N, W, seed, copies=3):
    """Packed bucket: every pin stored on 1..copies random partitions."""
    rng = np.random.default_rng(seed)
    lo = 1 if W == 1 else 64 * (W - 1) + 1
    sizes = rng.integers(lo, 64 * W + 1, size=B)
    codes = np.zeros((B, N, W), dtype=np.uint64)
    rem = np.zeros((B, W), dtype=np.uint64)
    for b in range(B):
        j = np.arange(int(sizes[b]))
        bits = np.uint64(1) << (j % 64).astype(np.uint64)
        np.bitwise_or.at(rem[b], j // 64, bits)
        for _ in range(int(rng.integers(1, copies + 1))):
            np.bitwise_or.at(codes[b], (rng.integers(0, N, size=len(j)),
                                        j // 64), bits)
    return codes, rem


def _port_rounds(codes, rem):
    ch, bad = cover_rounds(torch.from_numpy(codes.view(np.int64)),
                           torch.from_numpy(rem.view(np.int64)))
    assert ch.dtype == torch.int32 and bad.dtype == torch.bool
    return ch.numpy(), bad.numpy()


@pytest.mark.parametrize("B,N,W", [(1, 1, 1), (5, 3, 1), (40, 12, 1),
                                   (17, 35, 2), (9, 64, 3), (3, 256, 1)])
def test_rounds_match_reference(B, N, W):
    codes, rem = _bucket(B, N, W, seed=B * 100 + N + W)
    want = ref_device_rounds(codes, rem)
    assert want is not None
    ch, bad = _port_rounds(codes, rem)
    assert not bad.any()
    assert ch.shape == (B, min(N, 64 * W))
    used = int((ch >= 0).any(axis=0).sum())
    np.testing.assert_array_equal(ch[:, :used].astype(np.int64), want)
    assert (ch[:, used:] == -1).all()


def test_lowest_id_wins_ties():
    # every partition stores every pin: round 0 must pick partition 0
    codes = np.full((4, 6, 1), np.uint64(0xFF), dtype=np.uint64)
    rem = np.full((4, 1), np.uint64(0xFF), dtype=np.uint64)
    ch, _ = _port_rounds(codes, rem)
    np.testing.assert_array_equal(ch[:, 0], 0)
    np.testing.assert_array_equal(ch[:, 1:], -1)
    np.testing.assert_array_equal(ch[:, :1],
                                  ref_device_rounds(codes, rem))


def test_uncoverable_row_is_flagged_only():
    codes, rem = _bucket(6, 8, 1, seed=3)
    codes[2] = 0
    ch, bad = _port_rounds(codes, rem)
    np.testing.assert_array_equal(bad, [False, False, True, False, False,
                                        False])
    assert (ch[2] == -1).all()
    assert ref_device_rounds(codes, rem) is None
    ok = np.ones(6, dtype=bool)
    ok[2] = False
    want = ref_device_rounds(codes[ok], rem[ok])
    np.testing.assert_array_equal(ch[ok][:, : want.shape[1]], want)


@pytest.mark.parametrize("variant", ["", "spanrounddevice",
                                     "spanroundnumpy+spandevice"])
def test_uncoverable_query_error_text(variant):
    member = np.zeros((3, 6), dtype=bool)
    member[0, [0, 1, 2]] = True
    member[1, [3]] = True
    ref = RefHypergraph.from_edges([[0, 1], [2, 3], [3, 4, 5]], num_nodes=6)
    hg = from_reference_arrays(ref.edge_ptr, ref.edge_nodes,
                               ref.node_weights, ref.edge_weights, 6)
    with pytest.raises(ValueError) as want:
        ref_batched_cover(ref.edge_ptr, ref.edge_nodes, member)
    flags.set_variant(variant)
    with pytest.raises(ValueError) as got:
        batched_cover_csr(hg.edge_ptr, hg.edge_nodes, member, device="cpu")
    assert str(got.value) == str(want.value)
    assert str(got.value) == "query 2 contains items not stored on any partition"


def test_plain_is_what_cpu_runs():
    codes, rem = _bucket(8, 10, 2, seed=5)
    c = torch.from_numpy(codes.view(np.int64))
    r = torch.from_numpy(rem.view(np.int64))
    before = cover_rounds.launches
    for a, b in zip(cover_rounds(c, r), cover_rounds_plain(c, r)):
        assert torch.equal(a, b)
    assert cover_rounds.launches == before

