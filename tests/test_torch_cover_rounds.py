"""cover_rounds: the port's whole-bucket greedy round loop (plain PyTorch
version on CPU tensors) against the JAX package's jitted
``_device_cover_rounds`` on jax-CPU, on the same seeded packed buckets.
Chosen partitions are integers, so every comparison is exact."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import flags as ref_flags
from repro.core.hypergraph import Hypergraph as RefHypergraph
from repro.core.setcover import _device_cover_rounds as ref_device_rounds
from repro.core.setcover import _round_loop_fn as ref_round_loop
from repro.core.setcover import batched_cover_csr as ref_batched_cover
from repro_torch import flags
from repro_torch.core import batched_cover_csr, from_reference_arrays
from repro_torch.kernels.cover_rounds import ops as cover_ops
from repro_torch.kernels.cover_rounds.ops import (cover_rounds,
                                                   cover_rounds_plain,
                                                   rounds_class)

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


# besides small buckets, the kernel's class edges: the register class (W 1,
# N <= 256) and the shared class (W <= 8, N W <= 2048 words), one past
# each; N 31-65 cross the rows a lane holds (1, 2, 4 rows); W 2-8 are the
# shared class's rem widths
@pytest.mark.parametrize("B,N,W", [
    (1, 1, 1), (5, 3, 1), (40, 12, 1), (17, 35, 2), (9, 64, 3), (3, 256, 1),
    (7, 31, 1), (7, 32, 1), (7, 33, 1), (7, 64, 1), (7, 65, 1), (7, 256, 1),
    (5, 257, 1), (3, 2048, 1), (3, 2049, 1), (4, 256, 8), (4, 257, 8),
    (6, 35, 3), (6, 35, 4), (6, 35, 5), (6, 35, 6), (6, 35, 7), (6, 35, 8),
    (5, 8, 9)])
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



def test_equal_gains_on_different_lanes_go_to_the_lower_id():
    # partitions 5 and 37 (lanes 5 of a warp's first and second rows) both
    # store every pin; the others store a strict subset
    rng = np.random.default_rng(11)
    B, N = 6, 64
    rem = np.full((B, 1), np.uint64(0xFFFF), dtype=np.uint64)
    codes = (rng.integers(0, 2**16, size=(B, N, 1), dtype=np.uint64)
             & np.uint64(0x7FFF))
    codes[:, 5] = codes[:, 37] = rem
    ch, bad = _port_rounds(codes, rem)
    assert not bad.any()
    np.testing.assert_array_equal(ch[:, 0], 5)
    np.testing.assert_array_equal(ch[:, 1:], -1)
    np.testing.assert_array_equal(ch[:, :1], ref_device_rounds(codes, rem))


def test_row_that_goes_bad_keeps_its_earlier_rounds():
    # query 1's pin 9 is stored nowhere: it covers pins 0-8 in good rounds,
    # then its best gain is 0 while pin 9 remains
    codes, rem = _bucket(4, 8, 1, seed=21)
    rem[1] = np.uint64(0x3FF)
    codes[1] = 0
    for j in range(9):
        codes[1, j % 3, 0] |= np.uint64(1) << np.uint64(j)
    codes[1, 4, 0] |= np.uint64(0x3)
    ch, bad = _port_rounds(codes, rem)
    np.testing.assert_array_equal(bad, [False, True, False, False])
    assert (ch[1, :3] >= 0).all() and (ch[1, 3:] == -1).all()
    B, N, W = codes.shape
    loop = ref_round_loop(B, N, 2 * W, min(N, 64 * W))
    want_ch, want_bad = loop(codes.view(np.uint32).reshape(B, N, 2 * W),
                             rem.view(np.uint32).reshape(B, 2 * W))
    np.testing.assert_array_equal(bad, np.asarray(want_bad))
    np.testing.assert_array_equal(ch, np.asarray(want_ch).T)


@pytest.mark.parametrize("N,W,want", [
    (0, 1, "register"), (35, 1, "register"), (64, 1, "register"),
    (256, 1, "register"), (257, 1, "shared"), (2048, 1, "shared"),
    (2049, 1, "global"), (0, 2, "shared"), (35, 2, "shared"),
    (1024, 2, "shared"), (1025, 2, "global"), (256, 8, "shared"),
    (257, 8, "global"), (1, 9, "global"), (256, 32, "global"),
    (4, 0, "global")])
def test_rounds_class_edges(N, W, want):
    assert rounds_class(N, W) == want


def test_rounds_class_matches_the_source_constants():
    src = (Path(cover_ops.__file__).resolve().parents[2] / "csrc"
           / "cover_rounds.cu").read_text()
    consts = {name: int(value) for name, value in re.findall(
        r"constexpr int (k\w+) = (\d+);", src)}
    assert consts["kRegMaxN"] == cover_ops.REGISTER_MAX_N
    assert consts["kSmemMaxW"] == cover_ops.SHARED_MAX_W
    assert consts["kSmemMaxWords"] == cover_ops.SHARED_MAX_WORDS
